"""The 3D swelling cell of the benchmark (``swelling3d-n20`` under the
plateau traffic) on the port's CPU path, at N=2 and 3 window steps:

- ``swelling_3d.setup(argv, overrides)`` takes the harness's parameters
  (``t0``) as ``swelling.setup`` does;
- the plain reference's operator and right-hand sides
  (``solverbench/reference/swelling3d.py``) equal the port's;
- sound runs come out correct and read every per-layer metric that does
  not need the card's trace, ``dia_fill`` and ``k1_scalar_share`` from the
  port's counters;
- two seeds start at two times on the load's plateau and take the same
  iterations at every step;
- an answer altered after the solver's test, a state left unchanged by
  the window's steps, and the float32 control come out not correct.

The harness reports nothing in a process where jax is loaded, as this
suite's conftest loads it, so its runs go through this file run as a
script in a process of its own (``runs``).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CELL = "swelling3d-n20-inexact-3way-plateau"
TINY_N = 2
TINY_STEPS = 3
SEEDS = (2**31 + 11, 2**34 + 3)  # t0 1.8 and 1.5
# name -> (seed, traced, fault)
RUNS = {
    "sound": (SEEDS[0], True, None),
    "second seed": (SEEDS[1], False, None),
    "altered answer": (SEEDS[0], False, "altered answer"),
    "state left unchanged": (SEEDS[0], False, "state left unchanged"),
    "float32 control": (SEEDS[0], False, "float32 control"),
}
STATE = ("sol", "us_nm1", "us_nm2", "uf_nm1", "p_nm1", "last_result")


def make_root(path) -> str:
    """A checkout-like root: the repository's BENCHMARK.json and data
    files, the cell's configuration at TINY_N and its traffic at
    TINY_STEPS steps."""
    src = os.path.join(REPO, "solverbench")
    data = os.path.join(path, "solverbench")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(src, sub), os.path.join(data, sub))
    for sub, key, value in (("configs/swelling3d-n20.json", "N", TINY_N),
                            ("traffic/inexact-diagonal-3way-plateau.json", "steps", TINY_STEPS)):
        file = os.path.join(data, sub)
        with open(file) as f:
            obj = json.load(f)
        obj[key] = value
        with open(file, "w") as f:
            json.dump(obj, f)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), path)
    return str(path)


def _runs(root) -> dict:
    """Each of RUNS through ``harness.run_cell`` on the CPU: its exit code,
    result line, iterations a step and the port's banded totals."""
    import io
    import time

    from porotpu_torch.models import poromechanics
    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.utils import trace
    from solverbench import harness
    from solverbench.spec import Bench

    iters, faults = [], set()
    step, fgmres = poromechanics.Poromechanics.solve_time_step, poromechanics.fgmres

    def recorded(self, t):
        # from the window's first step on, the fault returns the state before it
        kept = ({k: getattr(self, k) for k in STATE}
                if iters and "state left unchanged" in faults else {})
        iters.append(step(self, t))
        for k, v in kept.items():
            setattr(self, k, v)
        return iters[-1]

    def altered(*args, **kwargs):
        res = fgmres(*args, **kwargs)
        if "altered answer" in faults:
            res.x = res.x * (1.0 + 1e-4)
        return res

    poromechanics.Poromechanics.solve_time_step = recorded
    poromechanics.fgmres = altered
    out = {}
    for name, (seed, traced, fault) in RUNS.items():
        iters.clear()
        faults.clear()
        faults.add(fault)
        dia_kernel.reset_counts()
        res, err = io.StringIO(), io.StringIO()
        rc = harness.run_cell(CELL, seed, 60.0, traced, time.perf_counter(), bench=Bench(root),
                              device="cpu", out=res, err=err,
                              dtype="float32" if fault == "float32 control" else None)
        band = trace.banded_totals()
        lines = res.getvalue().strip().splitlines()
        out[name] = {"rc": rc, "err": err.getvalue()[-3000:], "iters": list(iters),
                     "result": json.loads(lines[-1]) if lines else None,
                     "fill": band.fill, "scalar_share": band.k1_scalar_share}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("swelling3d"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cell():
    from solverbench.spec import Bench

    return Bench(REPO).cell(CELL)


def test_setup_takes_the_harness_overrides():
    from porotpu_torch.drivers import swelling_3d

    argv = ["-N", "1", "--device", "cpu"]
    assert swelling_3d.setup(argv).t0 == 0.0
    pb = swelling_3d.setup(argv, {"t0": 1.7, "ks": 1e7})
    assert pb.t0 == 1.7 and pb.parameters["ks"] == 1e7


def test_reference_operator_and_rhs_equal_the_ports():
    from porotpu_torch.drivers import swelling_3d
    from porotpu_torch.fem.bcs import bc_dofs_values
    from solverbench import harness
    from solverbench.reference.system import System
    from solverbench.spec import problem_module

    cell = _cell()
    prob = problem_module(cell.config)
    pb = swelling_3d.setup(["-N", str(TINY_N), "--petsc-options",
                            cell.path("traffic", cell.traffic["options_file"]),
                            "--pc-type", cell.traffic["pc_type"], "--device", "cpu"], {"t0": 1.5})
    for slot in prob.LOAD_SLOTS:
        setattr(pb.assembler, slot, harness.Scaled(getattr(pb.assembler, slot), 1.3))
    ref = System(prob, TINY_N, prob.loads({s: 1.3 for s in prob.LOAD_SLOTS}))
    asm = pb.assembler
    asm.assemble()
    order = ("s", "f", "p")
    A = sp.bmat([[asm.A_blocks.get((r, c)) for c in order] for r in order], format="csr")
    dofs, _ = bc_dofs_values(pb.bcs)
    keep = np.ones(A.shape[0])
    keep[dofs] = 0.0
    A = (sp.diags(keep) @ A + sp.diags(1.0 - keep)).tocsr()
    assert A.shape == ref.A.shape and sorted(dofs) == sorted(ref.bc_dofs)
    assert abs(A - ref.A).max() <= 1e-12 * abs(ref.A).max()
    pb.create_solver()
    pb.first_timestep = False
    xs = [np.zeros(ref.n)] * 2
    t = 1.5
    for _ in range(3):
        t += pb.dt
        pb.solve_time_step(t)
        b_port = pb.last_rhs.numpy()[pb.pad_index]
        b_ref = ref.rhs(t, xs[-1], xs[-2])
        assert np.abs(b_port - b_ref).max() <= 1e-12 * np.abs(b_ref).max()
        xs.append(pb.unpadded_solution())


def test_sound_run_is_correct_and_reads_the_port_counters(runs):
    run = runs["sound"]
    assert run["rc"] == 0, run["err"]
    res = run["result"]
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 1 + TINY_STEPS + 2  # warm, window, traced steps
    # the card's trace reads nothing on the CPU
    assert set(res["metrics"]) == {"assemble_s", "pc_setup_s", "rhs_ms", "iters_per_step",
                                   "dia_fill", "k1_scalar_share"}
    assert res["metrics"]["dia_fill"]["value"] == run["fill"] > 0
    assert res["metrics"]["k1_scalar_share"]["value"] == run["scalar_share"]
    # N=2: every P2 vector field has 3 x 5^3 rows, odd, so K1 runs scalar
    assert run["scalar_share"] == 100.0


def test_plateau_seeds_start_apart_and_take_the_same_iterations(runs):
    from solverbench import traffic
    from solverbench.spec import problem_module

    cell = _cell()
    slots = problem_module(cell.config).LOAD_SLOTS
    (t_a, f_a), (t_b, f_b) = (traffic.draw(cell.traffic, s, slots) for s in SEEDS)
    assert t_a != t_b and min(t_a, t_b) >= 1.5 and f_a == f_b == {s: 1.0 for s in slots}
    a, b = runs["sound"], runs["second seed"]
    assert b["rc"] == 0 and b["result"]["correct"], b["err"]
    assert len(b["iters"]) == 1 + TINY_STEPS
    assert a["iters"][: 1 + TINY_STEPS] == b["iters"]


@pytest.mark.parametrize("name", ["altered answer", "state left unchanged", "float32 control"])
def test_a_wrong_answer_is_not_correct(runs, name):
    run = runs[name]
    assert run["rc"] == 0, run["err"]
    assert not run["result"]["correct"] and run["result"]["failed"] > 0
    if name == "float32 control":  # f32 meets the test; its residual parts from the claim
        gap = run["result"]["checks"]["resid_gap"]
        assert gap["value"] > gap["limit"]


if __name__ == "__main__":
    print(json.dumps(_runs(sys.argv[1])))

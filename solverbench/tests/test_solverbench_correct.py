"""The comparison that decides ``correct``, on the port's CPU path at a
tiny N of each configuration: the reference's operator and right-hand
sides (its own loads against the port's, scaled alike) equal the port's,
sound runs come out correct, and the control (float32) and each fault a
time-stepping cell can have come out not correct."""

import io
import json
import time

import numpy as np
import pytest
import scipy.sparse as sp

from solverbench import harness
from solverbench.reference.system import System
from solverbench.spec import Bench, problem_module

CELLS = ["footing-n20-inexact", "swelling-n160-inexact-3way"]


def _run(root, workload, seed=2**31 + 11, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(workload, seed, 60.0, False, time.perf_counter(), bench=Bench(str(root)),
                          device="cpu", out=out, err=err, **kw)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_reference_operator_and_rhs_equal_the_ports(fixture_root, workload):
    from porotpu_torch.fem.bcs import bc_dofs_values

    cell = Bench(str(fixture_root)).cell(workload)
    cfg = cell.config
    prob = problem_module(cfg)
    driver = __import__("porotpu_torch.drivers." + cfg["driver"], fromlist=["setup"])
    pb = driver.setup(["-N", str(cfg["N"]), "--petsc-options",
                       cell.path("traffic", cell.traffic["options_file"]),
                       "--pc-type", cell.traffic["pc_type"], "--device", "cpu"], {"t0": 0.3})
    for slot in prob.LOAD_SLOTS:
        setattr(pb.assembler, slot, harness.Scaled(getattr(pb.assembler, slot), 1.7))
    ref = System(prob, cfg["N"], prob.loads({s: 1.7 for s in prob.LOAD_SLOTS}))
    asm = pb.assembler
    asm.assemble()
    order = ("s", "f", "p")
    A = sp.bmat([[asm.A_blocks.get((r, c)) for c in order] for r in order], format="csr")
    dofs, _ = bc_dofs_values(pb.bcs)
    keep = np.ones(A.shape[0])
    keep[dofs] = 0.0
    A = (sp.diags(keep) @ A + sp.diags(1.0 - keep)).tocsr()
    assert abs(A - ref.A).max() <= 1e-12 * abs(ref.A).max()
    pb.create_solver()
    pb.first_timestep = False
    xs = [np.zeros(ref.n)] * 2
    t = 0.3
    for _ in range(3):
        t += pb.dt
        pb.solve_time_step(t)
        b_port = pb.last_rhs.numpy()[pb.pad_index]
        b_ref = ref.rhs(t, xs[-1], xs[-2])
        assert np.abs(b_port - b_ref).max() <= 1e-12 * np.abs(b_ref).max()
        xs.append(pb.unpadded_solution())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_float32_control_is_not(fixture_root, workload):
    res = _run(fixture_root, workload)
    assert res["correct"] and res["failed"] == 0
    steps = Bench(str(fixture_root)).cell(workload).traffic["steps"]
    assert res["attempted"] == 1 + steps  # the warm step and the traffic's steps
    assert set(res["metrics"]) == {"step_s", "setup_s"}
    ctl = _run(fixture_root, workload, dtype="float32")
    assert not ctl["correct"] and ctl["failed"] > 0
    assert ctl["checks"]["resid_gap"]["value"] > ctl["checks"]["resid_gap"]["limit"]


def _state_left_unchanged(monkeypatch):
    """From the second step on (the window's first), a step solves and
    then returns the previous state."""
    from porotpu_torch.models.poromechanics import Poromechanics

    orig = Poromechanics.solve_time_step
    names = ("sol", "us_nm1", "us_nm2", "uf_nm1", "p_nm1", "last_result")
    calls = {"n": 0}

    def step(self, t):
        calls["n"] += 1
        if calls["n"] < 2:
            return orig(self, t)
        kept = {k: getattr(self, k) for k in names}
        its = orig(self, t)
        for k, v in kept.items():
            setattr(self, k, v)
        return its

    monkeypatch.setattr(Poromechanics, "solve_time_step", step)


def _answer_altered(monkeypatch):
    """The solver's x altered by one part in ten thousand where it is made."""
    from porotpu_torch.models import poromechanics

    orig = poromechanics.fgmres

    def fgmres(*args, **kwargs):
        res = orig(*args, **kwargs)
        res.x = res.x * (1.0 + 1e-4)
        return res

    monkeypatch.setattr(poromechanics, "fgmres", fgmres)


def _load_altered(monkeypatch):
    """The port's surface loads a thousandth too large where they are made."""
    from porotpu_torch.models import loads

    for cls in (loads.NormalLoad, loads.ExprLoad):
        orig = cls.eval
        monkeypatch.setattr(cls, "eval", lambda self, t, x, n=None, f=orig: 1.001 * f(self, t, x, n))


@pytest.mark.parametrize("fault", [_state_left_unchanged, _answer_altered, _load_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_come_out_not_correct(fixture_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = _run(fixture_root, workload)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_card_reads_its_layers(fixture_root, cuda_device, workload):
    """A traced run on the card at a small N whose blocks keep the cell's
    formats (banded for swelling, ELL for footing): the profiler's K1/K2
    launches and ELL spans are the products the wrappers counted, but for
    records the profiler drops (2.5% of K1's in a second profiling
    session in one process), and each per-layer metric of the cell has a
    reading."""
    out, err = io.StringIO(), io.StringIO()
    bench = Bench(str(fixture_root))
    name = bench.cell(workload).config["name"]
    path = fixture_root / "solverbench" / "configs" / (name + ".json")
    cfg = json.loads(path.read_text())
    cfg["N"] = {"footing2d-n20": 10, "swelling2d-n160": 40}[name]
    path.write_text(json.dumps(cfg))
    rc = harness.run_cell(workload, 2**31 + 5, 1.0, True, time.perf_counter(), bench=bench,
                          out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"]
    assert set(res["metrics"]) == {m["name"] for m in bench.metrics(workload, True)}
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
    line = [ln for ln in err.getvalue().splitlines() if ln.startswith("trace:")][0]
    counts = [int(w) for w in line.replace(",", " ").replace(";", " ").split() if w.isdigit()]
    _, _, k1, k1_calls, k2, k2_calls, spans, ell_calls = counts[:8]
    for seen, calls in ((k1, k1_calls), (k2, k2_calls), (spans, ell_calls)):
        assert 0.95 * calls <= seen <= calls

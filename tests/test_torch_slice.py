"""Port parity for the whole slice: one swelling-3d time step through
porotpu_torch against porotpu, plus the port's import and option rules.

Swelling-3d N=3 with the bench overrides in f64: the same outer FGMRES
iteration count, the residual history to 1e-8 relative (both record it
in f32), the solution to 1e-10 relative (summation order only) and the
bench's true-residual field-wise guard (bench.py:300-310).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from porotpu.models import benchmarks as jbench
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.solvers.convergence import FieldwiseTest
from porotpu_torch.utils.options import OptionsDB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(BENCH_OVERRIDES, dtype="float64")


@pytest.fixture(scope="module")
def solved():
    jp = jbench.swelling_3d(3, overrides=F64)
    jp.solve()
    p = swelling_3d(3, overrides=F64, device="cpu")
    p.solve()
    return jp, p


def test_slice_iterations_and_history_match_porotpu(solved):
    jp, p = solved
    jr, r = jp.last_result, p.last_result
    assert r.converged and bool(jr.converged)
    assert r.iters == int(jr.iters) and p.iteration_log == jp.iteration_log
    jh = np.asarray(jr.history)
    assert np.array_equal(np.isnan(r.history), np.isnan(jh))
    live = ~np.isnan(jh)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=1e-8, atol=0)


def test_slice_solution_matches_porotpu(solved):
    jp, p = solved
    x = p.sol.numpy()
    jx = np.asarray(jp.sol)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    np.testing.assert_allclose(p.unpadded_solution(), jp.unpadded_solution(), rtol=0,
                               atol=1e-10 * np.abs(jx).max())


def test_slice_true_residual_guard(solved):
    _, p = solved
    b = p.get_rhs(p.t)
    with torch.inference_mode():
        r = b - p.A_dev.matvec(p.sol)
        ea, er = FieldwiseTest.from_sizes(p.padded_sizes, b).errors(r)
    assert float(ea) < 1e-7 or float(er) < 1e-5


@pytest.mark.parametrize("jax_blocked", [True, False])
def test_port_runs_without_jax(jax_blocked):
    """Import, build and solve swelling-3d N=2 with jax unimportable, and
    with jax importable: the port must import neither jax nor any module
    named porotpu either way."""
    code = (
        "import sys\n"
        + ("sys.modules['jax'] = None\n" if jax_blocked else "")
        + "from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d\n"
        "p = swelling_3d(2, overrides=dict(BENCH_OVERRIDES, dtype='float64'), device='cpu')\n"
        "its = p.solve()\n"
        "assert p.last_result.converged, its\n"
        "jax = [m for m in sys.modules if m.split('.')[0] == 'jax']\n"
        f"assert jax == {['jax'] if jax_blocked else []!r}, jax\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'porotpu']\n"
        "assert bad == [], bad\n"
        "print('SOLVED', its[0])\n"
    )
    env = dict(os.environ)
    env.pop("PORO_PLATFORM", None)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SOLVED" in proc.stdout


def test_port_sources_never_import_jax():
    """Neither jax nor anything named porotpu (the port keeps its own copies)."""
    pat = re.compile(r"^\s*(import\s+(jax|porotpu\b)|from\s+(jax|porotpu)[\s.])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "porotpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for sub in ("utils", "drivers"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    bad = [f for f in files if pat.search(open(f).read())]
    assert bad == []


def test_options_override_applies_before_chunking():
    """global_ksp_max_it caps the whole solve, which "solver chunk" then
    splits — not each chunk (porotpu/models/poromechanics.py:799 applies
    it after the chunk clamp)."""
    odb = OptionsDB({"global_ksp_max_it": "3"})
    p = swelling_3d(
        2, overrides=dict(F64, **{"solver chunk": 1, "options db": odb}), device="cpu"
    )
    p.create_solver()
    p.first_timestep = False
    assert p._maxiter == 1 and p._solve_chunks == 3
    its = p.solve_time_step(p.t0 + p.dt)
    assert its == 3 and not p.last_result.converged


def test_chunk_must_be_a_multiple_of_restart():
    p = swelling_3d(
        2, overrides=dict(F64, **{"solver chunk": 75, "gmres restart": 50}), device="cpu"
    )
    with pytest.raises(ValueError, match="multiple of the gmres restart"):
        p._finalize_solver()


@pytest.mark.parametrize(
    "override,what",
    [
        ({"solver type": "aar"}, "'aar'"),
        ({"inner accel order": 1}, "Anderson"),
        ("petsc-options-exact-iterative", "fgmres\\+fs"),
    ],
    ids=["override1", "override3", "override4"],
)
def test_unported_branches_raise(override, what):
    if isinstance(override, str):  # an options file: its fp block asks for fgmres+fs
        override = {"options db": OptionsDB.from_file(os.path.join(REPO, override))}
    p = swelling_3d(2, overrides=dict(F64, **override), device="cpu")
    with pytest.raises(NotImplementedError, match=what + r".*ROADMAP M7\.\d"):
        p.create_solver()

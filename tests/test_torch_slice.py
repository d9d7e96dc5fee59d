"""Port parity for the whole slice: one swelling-3d time step through
porotpu_torch against porotpu, plus the port's import and option rules.

Swelling-3d N=3 with the bench overrides in f64: the same outer FGMRES
iteration count, the residual history to 1e-8 relative (both record it
in f32), the solution to 1e-10 relative (summation order only) and the
bench's true-residual field-wise guard (bench.py:300-310).
"""

import os
import re

import numpy as np
import pytest
import torch

from porotpu.models import benchmarks as jbench
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.solvers.convergence import FieldwiseTest
from porotpu_torch.utils.options import OptionsDB
from torch_k1_cases import import_checks, one_blas_thread  # noqa: F401

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
    named porotpu either way (one subprocess, each case from a fresh import
    of the port)."""
    got = import_checks()["jax_blocked" if jax_blocked else "jax_importable"]
    assert got["converged"], got["iterations"]
    assert got["foreign"] == (["jax"] if jax_blocked else []), got["foreign"]


def test_port_sources_never_import_jax():
    """Neither jax nor anything named porotpu (the port keeps its own copies)."""
    pat = re.compile(r"^\s*(import\s+(jax|porotpu\b)|from\s+(jax|porotpu)[\s.])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "porotpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for sub in ("utils", "drivers"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for mod in ("solvers/aar.py", "solvers/anderson.py", "solvers/basic.py", "solvers/cg.py",
                "models/subsystems.py", "drivers/solid.py", "drivers/fluid_pressure.py",
                "utils/cache.py", "utils/io.py", "fem/meshio.py"):
        assert os.path.join(REPO, "porotpu_torch", *mod.split("/")) in files, mod
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
        ({"solver cache path": None}, "solver cache"),
        ({"inner monitor": True}, "inner monitors"),
    ],
    ids=["override1", "override3"],
)
def test_unported_branches_raise(override, what, tmp_path, capfd):
    """The two branches these cases checked the raises of are ported (ROADMAP
    M7.5, M7.6), at swelling-3d N=2 with the bench overrides in f64: the
    solver cache saves the solver and a fresh problem restores it, the same
    iterations to the same solution; the inner monitors print one line for
    each inner solve of each PC apply, porotpu's labels (the bench's
    preonly AMG solves hold their block operator)."""
    if what == "solver cache":
        override = {"solver cache path": str(tmp_path / "bench.pkl")}
    p = swelling_3d(2, overrides=dict(F64, **override), device="cpu")
    capfd.readouterr()
    p.solve()
    out = capfd.readouterr().out
    if what == "solver cache":
        p.cache_writer.join(timeout=60)
        q = swelling_3d(2, overrides=F64, device="cpu")
        assert q.try_load_solver_cache(override["solver cache path"])
        q.solve()
        assert q.iteration_log == p.iteration_log and torch.equal(q.sol, p.sol)
    else:
        labels = re.findall(r"^  \[inner (\w+)\] \|r\|=\S+$", out, re.M)
        assert labels == ["s", "fp_f", "fp_S"] * p.iteration_log[0], labels

"""Port parity for ROADMAP M7.1: CastPC, bench.py's f64 iterative
refinement, the 3-way block preconditioner through the drivers, and the
2-way pc types nothing else runs.  porotpu_torch against porotpu on the
same problem on the CPU.

- CastPC: swelling-3d N=3 with the bench overrides, f64 outer solve and
  the PC built in f32 (``pc dtype`` float32, bench.py's f64 datapoint).
- f64-IR (``porotpu_torch/tools/bench.py:refine``): f32 solves against the
  f64 true residual at N=3, and the roofline helpers' operator size on
  the same f32 problem.
- The driver runs in f64, as tests/test_torch_drivers.py holds the 2-way
  ones: the same iteration count, the residual history to 1e-8 relative
  (both record it in f32), the solution to 1e-10 relative (summation
  order only) and the true-residual guard at the problem's tolerances.
  The 3-way PC: swelling N=4 ``diagonal 3-way`` under
  petsc-options-inexact and -exact (porotpu: 12 and 12), footing N=3
  ``undrained 3-way`` under -inexact (46).  The 2-way pc types nothing
  else runs, swelling N=4 under -inexact: ``diagonal 3-way-II`` (the
  grad-div fluid block, 119) and ``lu`` (P = A, 8).  For each run, its
  assembled preconditioner blocks and P_diff, and its BC-applied padded
  P_diff, equal porotpu's CSR.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porotpu.models import benchmarks as jbench
from porotpu.utils.parser import Parser as JParser
from porotpu_torch.models import benchmarks
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.solvers.convergence import FieldwiseTest
from porotpu_torch.tools import bench
from porotpu_torch.utils import roofline
from porotpu_torch.utils.parser import Parser
from torch_k1_cases import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (benchmark, N, command line, porotpu's iteration count)
RUNS = {
    "swelling_3way_inexact": (
        "swelling", 4, ["--petsc-options", "petsc-options-inexact", "--pc-type", "diagonal 3-way"],
        12,
    ),
    "swelling_3way_exact": (
        "swelling", 4, ["--petsc-options", "petsc-options-exact", "--pc-type", "diagonal 3-way"],
        12,
    ),
    "footing_3way_inexact": (
        "footing", 3, ["--petsc-options", "petsc-options-inexact", "--pc-type", "undrained 3-way"],
        46,
    ),
    "swelling_3way_II_inexact": (
        "swelling", 4,
        ["--petsc-options", "petsc-options-inexact", "--pc-type", "diagonal 3-way-II"], 119,
    ),
    "swelling_lu_inexact": (
        "swelling", 4, ["--petsc-options", "petsc-options-inexact", "--pc-type", "lu"], 8,
    ),
}
# the runs of the 3-way PC; "diagonal 3-way-II" is a 2-way PC
THREE_WAY = ("swelling_3way_inexact", "swelling_3way_exact", "footing_3way_inexact")
CAST = dict(BENCH_OVERRIDES, dtype="float64", **{"pc dtype": "float32"})


def _guard(p, b, atol, rtol):
    """Whether the last solve passes the true-residual field-wise test."""
    with torch.inference_mode():
        r = b - p.A_dev.matvec(p.sol)
        ea, er = FieldwiseTest.from_sizes(p.padded_sizes, b).errors(r)
    return float(ea) < atol or float(er) < rtol


def test_cast_pc_slice_matches_porotpu():
    """The same iteration count; the residual history within 1e-3 relative
    and the solution within 1e-5 of max|x|: both sides apply an f32 PC
    whose rounding (summation order) differs, and FGMRES carries that
    difference into every direction it builds, so the f32 rounding, not
    the f64 solve, sets both tolerances.  Both pass bench.py's guard on
    the f64 true residual."""
    jp = jbench.swelling_3d(3, overrides=CAST)
    jp.solve()
    p = swelling_3d(3, overrides=CAST, device="cpu")
    p.solve()
    assert type(p.pc).__name__ == "CastPC" and p.sol.dtype == torch.float64
    jr, r = jp.last_result, p.last_result
    assert r.converged and bool(jr.converged)
    assert p.iteration_log == jp.iteration_log
    jh = np.asarray(jr.history)
    assert np.array_equal(np.isnan(r.history), np.isnan(jh))
    live = ~np.isnan(jh)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=1e-3, atol=0)
    x, jx = p.sol.numpy(), np.asarray(jp.sol)
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()
    b = p.get_rhs(p.t)
    assert _guard(p, b, 1e-7, 1e-5)
    jb = np.array(jp.get_rhs(jp.t))
    jres = jb - np.asarray(jp.A_dev.matvec(jp.sol))
    fw = FieldwiseTest.from_sizes(p.padded_sizes, torch.from_numpy(jb))
    ea, er = fw.errors(torch.from_numpy(jres))
    assert float(ea) < 1e-7 or float(er) < 1e-5


@pytest.fixture(scope="module")
def f32_pair():
    """bench.py's f32 configuration at N=3, built by the port and by
    porotpu (solvers created, not solved)."""
    p32 = bench.build_problem("float32", 3, device="cpu", cache_dir=None)
    jp = jbench.swelling_3d(3, overrides=dict(BENCH_OVERRIDES))
    jp.create_solver()
    return p32, jp


def test_refinement_reaches_f64_from_f32_solves(f32_pair):
    """bench.py's f64-IR datapoint at N=3: the first pass takes porotpu's
    f32 iteration count on the same right-hand side, and the loop ends
    with the field-wise test met in f64 at atol 1e-8 / rtol 1e-6 within
    its 4 passes."""
    p32, jp = f32_pair
    p64 = bench.build_problem("float64", 3, pc_dtype="float32", device="cpu", cache_dir=None)
    b64 = p64.get_rhs(p64.t0 + p64.dt)
    x, info = bench.refine(p32, p64.A_dev, b64, p64.padded_sizes)
    assert 1 <= info["passes"] <= bench.IR_PASSES
    assert info["abs"] <= bench.IR_ATOL or info["rel"] <= bench.IR_RTOL
    assert x.dtype == torch.float64
    ea, er = bench.guard(p64, b64, x)
    assert (ea, er) == (info["abs"], info["rel"])

    b32 = jnp.asarray(b64.numpy().astype(np.float32))
    jres = jp._jit_solve(jp.A_dev, jp.pc, b32, jnp.zeros_like(b32))
    assert info["f32_iters"][0] == int(jres.iters)


def test_roofline_counts_porotpus_padded_values_and_needs_the_card(f32_pair):
    p, jp = f32_pair
    assert roofline.padded_values(p.A_dev) == sum(
        int(e.nnz_padded) for e in jp.A_dev.blocks.values()
    )
    with pytest.raises(RuntimeError, match="not a CUDA card"):
        roofline.stream_peak(torch.float32, mb=1, device="cpu")
    with pytest.raises(RuntimeError, match="not a CUDA card"):
        roofline.op_stream_time(p.A_dev, torch.ones(sum(p.padded_sizes)))


def _argv(flags):
    """Flags with the options file as a path into the repository."""
    return [os.path.join(REPO, f) if f.startswith("petsc-options") else f for f in flags]


@pytest.fixture(scope="module", params=list(RUNS))
def run(request):
    name, N, flags, count = RUNS[request.param]
    jp = getattr(jbench, name)(N, parser=JParser(_argv(flags)))
    jp.solve()
    p = getattr(benchmarks, name)(N, parser=Parser(_argv(flags)), device="cpu")
    p.solve()
    return request.param, count, jp, p


def test_run_matches_porotpu(run):
    name, count, jp, p = run
    assert p.dtype == torch.float64
    assert p.iteration_log == jp.iteration_log == [count], name
    assert p.three_way == jp.three_way == (name in THREE_WAY)
    if name == "swelling_3way_exact":
        pc = p.pc
        assert [s.kind for s in (pc.solve_s, pc.solve_f, pc.solve_p, pc.solve_diff)] == ["lu"] * 4
    jr, r = jp.last_result, p.last_result
    assert r.converged and bool(jr.converged)
    jh = np.asarray(jr.history)
    assert np.array_equal(np.isnan(r.history), np.isnan(jh))
    live = ~np.isnan(jh)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=1e-8, atol=0)
    x, jx = p.sol.numpy(), np.asarray(jp.sol)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    assert _guard(p, p.last_rhs, float(p.parameters["solver atol"]),
                  float(p.parameters["solver rtol"]))


def _assert_csr_equal(M, J, key):
    assert M.shape == J.shape, key
    M, J = M.tocsr(), J.tocsr()
    np.testing.assert_array_equal(M.indptr, J.indptr, err_msg=str(key))
    np.testing.assert_array_equal(M.indices, J.indices, err_msg=str(key))
    scale = np.abs(J.data).max()
    np.testing.assert_allclose(M.data, J.data, rtol=1e-14, atol=1e-14 * scale, err_msg=str(key))


def test_preconditioner_blocks_match_porotpu_csr(run):
    """The assembled P blocks and P_diff of the run's pc type, and the
    BC-applied padded P_diff (rows zeroed at the pressure dofs of bcs and
    bcs_diff), equal porotpu's."""
    name, _, jp, p = run
    blocks, jblocks = p.assembler.P_blocks, jp.assembler.P_blocks
    assert sorted(blocks) == sorted(jblocks)
    for key, M in blocks.items():
        _assert_csr_equal(M, jblocks[key], key)
    Pd, jPd = p.assembler.P_diff_pp, jp.assembler.P_diff_pp
    assert (Pd is None) == (jPd is None) == (not p.three_way)
    _, _, Pd_bc, _ = p._bc_applied_blocks()
    _, _, jPd_bc, _ = jp._bc_applied_blocks()
    if p.three_way:
        _assert_csr_equal(Pd, jPd, "P_diff_pp")
        _assert_csr_equal(Pd_bc, jPd_bc, "P_diff_pp with BCs")
        assert Pd_bc.shape == (p.np_p, p.np_p)
    else:
        assert Pd_bc is None and jPd_bc is None

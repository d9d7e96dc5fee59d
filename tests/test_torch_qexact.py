"""Port parity for ROADMAP M7.2: coordinate-free (greedy) AMG and the
quasi-exact ``fgmres+fs`` fluid-pressure solve, porotpu_torch against
porotpu on the same inputs, f64 on the CPU.

- Greedy aggregates of ``_aggregate(_strength(_node_graph(A, d), theta))``
  equal porotpu's as integers, on a P2 Poisson graph, a 2-dof elasticity
  graph and a graph with isolated nodes.
- ``amg_setup(coords=None)``: the level sizes, every level's A and P as
  CSR to 1e-12 of their largest entry, their storage formats, and one
  V-cycle to 1e-12 of its largest value, on the elasticity block and on
  a mass-dominated block whose first strength graph is empty: above the
  dense cap the stall guard retries at theta / 4, under it the hierarchy
  stops.
- The ``fgmres+fs`` apply of swelling N=2 with petsc-options-exact-iterative
  and ``-fp_lu_fallback_iters 5``, so that the count and not rtol 1e-12
  stops the inner FGMRES and the comparison is elementwise: the port's
  own build and porotpu's solver converted by ``convert.to_torch``, to
  1e-10 relative.
- The 2-way qexact driver, swelling N=2, one step: porotpu's outer count,
  its residual history to 1e-8 and its solution to 1e-10 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from porotpu.models import benchmarks as jbench
from porotpu.precond import amg as jamg
from porotpu.utils.parser import Parser as JParser
from porotpu_torch.convert import to_torch
from porotpu_torch.fem import assemble
from porotpu_torch.fem.bcs import apply_bcs_matrix
from porotpu_torch.fem.dofmap import FunctionSpace
from porotpu_torch.fem.mesh import generate_square
from porotpu_torch.models import benchmarks
from porotpu_torch.precond import amg
from porotpu_torch.precond.inner import InnerSolver
from porotpu_torch.utils.parser import Parser
from torch_k1_cases import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QEXACT = os.path.join(REPO, "petsc-options-exact-iterative")


def _poisson_p2():
    mesh, *_ = generate_square(8, 1.0)
    V = FunctionSpace(mesh, 2)
    return apply_bcs_matrix(assemble.stiffness(V).tocsr(), V.boundary_nodes()), 1, None


def _elasticity():
    mesh, *_ = generate_square(8, 1.0)
    V = FunctionSpace(mesh, 2, vector=True)
    K = (assemble.hooke(V, mu=1.0, lam=1.0) + assemble.mass(V, 1e-3)).tocsr()
    return K, 2, amg.rigid_body_modes(V.node_coords)


def _isolated():
    """P1 Poisson with its boundary rows made identity, and a block of
    nodes connected to nothing."""
    mesh, *_ = generate_square(8, 1.0)
    V = FunctionSpace(mesh, 1)
    K = apply_bcs_matrix(assemble.stiffness(V).tocsr(), V.boundary_nodes())
    return sp.block_diag([K, sp.identity(7)], format="csr"), 1, None


def _mass_dominated(n=79):
    """I + 0.05 K on (n + 1)^2 P1 nodes: no off-diagonal entry is strong at
    theta 0.08 (0.05 < 0.08 * 1.2), each is at theta / 4."""
    mesh, *_ = generate_square(n, 1.0)
    K = assemble.stiffness(FunctionSpace(mesh, 1)).tocsr()
    return (sp.identity(K.shape[0]) + 0.05 * K).tocsr(), 1, None


GRAPHS = {"p2_poisson": _poisson_p2, "elasticity_2dof": _elasticity, "isolated": _isolated}


@pytest.mark.parametrize("case", list(GRAPHS))
def test_greedy_aggregates_equal_porotpus(case):
    A, d, _ = GRAPHS[case]()
    theta = 0.08
    got = amg._aggregate(amg._strength(amg._node_graph(A, d), theta))
    want = jamg._aggregate(jamg._strength(jamg._node_graph(A, d), theta))
    assert got.dtype == np.int64 and np.array_equal(got, np.asarray(want))
    assert 1 < got.max() + 1 < A.shape[0] // d
    if case == "isolated":
        assert len(set(got[-7:])) == 7 and not np.isin(got[-7:], got[:-7]).any()


def _csr(op):
    """Host CSR of a device operator of the port (DIA, Transposed, Dense, ELL)."""
    name = type(op).__name__
    if name == "Transposed":
        return _csr(op.inner).T.tocsr()
    if name == "Dense":
        return sp.csr_matrix(op.data.numpy())
    if name == "ELL":
        n, w = op.data.shape
        return sp.csr_matrix(
            (op.data.numpy().ravel(), (np.repeat(np.arange(n), w), op.cols.numpy().ravel())),
            shape=(n, op.ncols),
        )
    inv = np.full(op.ne, -1)
    inv[np.arange(op.ncols) if op.col_emb is None else op.col_emb.numpy()] = np.arange(op.ncols)
    rows, cols, vals = [], [], []
    for data, off in zip(op.data.numpy(), op.offsets):
        i = np.arange(op.nrows)
        e = i + off
        ok = (e >= 0) & (e < op.ne)
        ok[ok] &= inv[e[ok]] >= 0
        rows.append(i[ok]), cols.append(inv[e[ok]]), vals.append(data[ok])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(op.nrows, op.ncols),
    )


HIERARCHIES = {
    # (matrix, coarse size, levels): 578 -> 99 -> 12 x 12 dense
    "elasticity": (_elasticity, 60, 2),
    # 6400 rows, above the dense cap of 6000: the empty strength graph
    # stalls, the retry at theta / 4 gives 1080 aggregates, then 191
    "mass_dominated_retry": (_mass_dominated, 600, 2),
    # 441 rows, under the cap: the stall stops the hierarchy at once
    "mass_dominated_stall": (lambda: _mass_dominated(20), 100, 0),
}


@pytest.fixture(scope="module", params=list(HIERARCHIES))
def greedy_pair(request):
    make, coarse, _ = HIERARCHIES[request.param]
    A, d, B = make()
    kw = dict(dofs_per_node=d, B=B, coarse_size=coarse, presmooth=2, postsmooth=2)
    return (request.param, A, amg.amg_setup(A, dtype=torch.float64, **kw),
            jamg.amg_setup(A, dtype=jnp.float64, **kw))


def test_greedy_hierarchy_matches_porotpu(greedy_pair):
    case, A, mine, theirs = greedy_pair
    conv = to_torch(theirs)
    assert len(mine.levels) == len(conv.levels) == HIERARCHIES[case][2]
    assert mine.coarse_inv.shape == conv.coarse_inv.shape
    for lv, jlv in zip(mine.levels, conv.levels):
        for which in ("A", "P"):
            # device_matrix picks porotpu's storage format for each
            assert type(getattr(lv, which)) is type(getattr(jlv, which)), (case, which)
            got, want = _csr(getattr(lv, which)), _csr(getattr(jlv, which))
            assert got.shape == want.shape, (case, which)
            assert abs(got - want).max() <= 1e-12 * abs(want).max(), (case, which)
        assert lv.lmax == jlv.lmax
    ci = conv.coarse_inv
    assert (mine.coarse_inv - ci).abs().max() <= 1e-12 * ci.abs().max()
    if case.startswith("mass"):
        C = amg._node_graph(A, 1)
        assert amg._strength(C, 0.08).nnz == 0 and amg._strength(C, 0.02).nnz > 0


def test_greedy_vcycle_matches_porotpu(greedy_pair):
    _, A, mine, theirs = greedy_pair
    x = np.random.default_rng(5).normal(size=A.shape[0])
    want = np.asarray(jax.jit(lambda o, v: o(v))(theirs, jnp.asarray(x)))
    with torch.inference_mode():
        got = mine(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.fixture(scope="module")
def fp_solves(tmp_path_factory):
    """swelling N=2 with -fp_lu_fallback_iters 5: porotpu's built PC and
    the port's, and porotpu's fgmres+fs apply on a seeded vector."""
    path = tmp_path_factory.mktemp("opts") / "petsc-options-exact-iterative-5"
    path.write_text(open(QEXACT).read() + "\n-fp_lu_fallback_iters 5\n")
    flags = ["--petsc-options", str(path)]
    jp = jbench.swelling(2, parser=JParser(flags))
    jp._build_operators()
    p = benchmarks.swelling(2, parser=Parser(flags), device="cpu")
    p._build_operators()
    jfp = jp.pc.solve_fp
    x = np.random.default_rng(3).normal(size=jp.nf_p + jp.np_p)
    want = np.asarray(jax.jit(lambda o, v: o(v))(jfp, jnp.asarray(x)))
    return jfp, p.pc.solve_fp, x, want


@pytest.mark.parametrize("source", ["converted", "own_build"])
def test_fgmres_fs_apply_matches_porotpu(source, fp_solves):
    jfp, own, x, want = fp_solves
    assert jfp.kind == "fgmres+fs" and jfp.iters == 5
    memo = {}
    fp = to_torch(jfp, memo) if source == "converted" else own
    assert fp.kind == "fgmres+fs" and fp.iters == 5
    assert type(fp.mods["A"]).__name__ == "FieldMatrix"
    fs = fp.mods["fs"]
    assert type(fs).__name__ == "SchurFieldsplit"
    assert (fs.solve_f.kind, fs.solve_f.iters, fs.solve_S.kind) == ("cg+amg", 20, "plus-diag")
    assert fs.solve_S.mods["base"].kind == "lu"
    if source == "converted":
        # one port module for porotpu's fieldsplit, shared, not copied
        assert to_torch(jfp.payload["fs"], memo) is fs
    with torch.inference_mode():
        got = fp(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_qexact_driver_count_matches_porotpu():
    flags = ["--petsc-options", QEXACT]
    jp = jbench.swelling(2, parser=JParser(flags))
    jp.solve()
    p = benchmarks.swelling(2, parser=Parser(flags), device="cpu")
    p.solve()
    assert p.pc.solve_fp.kind == "fgmres+fs" and p.pc.solve_fp.iters == 60
    assert len(p.iteration_log) == 1 and p.iteration_log == jp.iteration_log
    jr, r = jp.last_result, p.last_result
    assert r.converged and bool(jr.converged)
    jh = np.asarray(jr.history)
    live = ~np.isnan(jh)
    assert np.array_equal(np.isnan(r.history), ~live)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=1e-8, atol=0)
    x, jx = p.sol.numpy(), np.asarray(jp.sol)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()


def test_unknown_inner_kind_raises():
    with pytest.raises(ValueError, match="unknown inner solver kind 'mumps'"):
        InnerSolver("mumps")

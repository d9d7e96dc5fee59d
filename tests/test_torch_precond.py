"""Port parity: one apply of the AMG V-cycle, the Schur fieldsplit and the
2-way block preconditioner, porotpu_torch against porotpu on the same
vector, in f64 to 1e-10 relative (summation order differs; a V-cycle
amplifies rounding by the operator's condition, far below this bound).

Each apply is checked twice: on porotpu's objects carried across by
``porotpu_torch.convert`` (tests the apply code) and on the port's own
host build (tests the copied host setup as well — its band offsets,
level counts, shapes and lmax must equal porotpu's).  The configuration
is swelling-3d N=3 with the bench overrides and ``amg coarse size`` 100,
so the solid AMG has two levels.

The host setup's sparse products (``amg.matmul``), forced into row blocks
by a lowered threshold, are scipy's whole ``A @ B`` bit for bit, on that
solid block's Galerkin product and on edge cases; and the solid block's
hierarchy, box and greedy, is the one its whole products give, bit for
bit, with the counter saying which products ran in blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from porotpu.models import benchmarks as jbench
from porotpu_torch.convert import to_torch
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.utils import trace
from torch_k1_cases import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

OVERRIDES = dict(BENCH_OVERRIDES, dtype="float64", **{"amg coarse size": 100})


@pytest.fixture(scope="module")
def builds():
    jp = jbench.swelling_3d(3, overrides=OVERRIDES)
    jp._build_operators()
    p = swelling_3d(3, overrides=OVERRIDES, device="cpu")
    p._build_operators()
    return jp, p


def _parts(pc, jax_side):
    """The three applies of a block PC: solid AMG, Schur fieldsplit, whole."""
    if jax_side:
        amg = pc.solve_s.payload["amg"]
    else:
        amg = pc.solve_s.mods["amg"]
    return {"amg_solid": amg, "schur_fieldsplit": pc.solve_fp, "block_pc": pc}


@pytest.fixture(scope="module")
def jax_applies(builds):
    """porotpu's apply of each part, {part: (x, y)}, from one jitted apply
    of its block PC on a seeded vector x: the bench's solid solve is one
    AMG V-cycle, so the block apply's solid rows are the AMG's apply on x's
    solid rows, and its fluid-pressure rows the Schur fieldsplit's apply on
    x's fp rows less the coupling of the solid result (porotpu's 2-way
    sweep, porotpu/precond/block.py, the coupling computed alongside)."""
    jp, _ = builds
    assert jp.pc.solve_s.kind == "amg" and jp.pc.solve_s.iters == 1
    ns = jp.ns_p
    x = np.random.default_rng(21).normal(size=sum(jp.padded_sizes))

    def apply(pc, v):
        y = pc(v)
        ys = y[:ns]
        return y, v[ns:] - jnp.concatenate([pc.Pfs.matvec(ys), pc.Pps.matvec(ys)])

    y, z = (np.array(a) for a in jax.jit(apply)(jp.pc, jnp.asarray(x)))
    return {"amg_solid": (x[:ns], y[:ns]), "schur_fieldsplit": (z, y[ns:]), "block_pc": (x, y)}


@pytest.mark.parametrize("source", ["converted", "own_build"])
@pytest.mark.parametrize("part", ["amg_solid", "schur_fieldsplit", "block_pc"])
def test_apply_matches_porotpu_f64(part, source, builds, jax_applies):
    jp, p = builds
    jop = _parts(jp.pc, True)[part]
    op = to_torch(jop) if source == "converted" else _parts(p.pc, False)[part]
    x, want = jax_applies[part]
    with torch.inference_mode():
        got = op(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-10, err


@pytest.fixture(scope="module")
def three_way_builds():
    """The same configuration with the 3-way block PC (``diagonal 3-way``)."""
    over = dict(OVERRIDES, **{"pc type": "diagonal 3-way"})
    jp = jbench.swelling_3d(3, overrides=over)
    jp._build_operators()
    p = swelling_3d(3, overrides=over, device="cpu")
    p._build_operators()
    x = np.random.default_rng(23).normal(size=sum(jp.padded_sizes))
    return jp, p, x, np.asarray(jax.jit(lambda o, v: o(v))(jp.pc, jnp.asarray(x)))


@pytest.mark.parametrize("source", ["converted", "own_build"])
def test_three_way_apply_matches_porotpu_f64(source, three_way_builds):
    """The 3-way double sweep: pressure and diffusion solves, two fluid
    and two solid solves, the weighted sum; f64 to 1e-12 relative."""
    jp, p, x, want = three_way_builds
    assert jp.pc.three_way and jp.pc.diff_rhs_mask is not None
    pc = to_torch(jp.pc) if source == "converted" else p.pc
    assert pc.three_way and (pc.w1, pc.w2) == (jp.pc.w1, jp.pc.w2)
    np.testing.assert_array_equal(pc.diff_rhs_mask.numpy(), np.asarray(jp.pc.diff_rhs_mask))
    assert pc.diff_rhs_mask.numpy().min() == 0.0  # the diffusion BC rows are masked
    with torch.inference_mode():
        got = pc(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= 1e-12, err


@pytest.fixture(scope="module")
def cast_builds():
    """The same configuration with the PC built in f32 under an f64 solve."""
    over = dict(OVERRIDES, **{"pc dtype": "float32"})
    jp = jbench.swelling_3d(3, overrides=over)
    jp._build_operators()
    p = swelling_3d(3, overrides=over, device="cpu")
    p._build_operators()
    x = np.random.default_rng(22).normal(size=sum(jp.padded_sizes))
    return jp, p, x, np.asarray(jax.jit(lambda o, v: o(v))(jp.pc, jnp.asarray(x)))


@pytest.mark.parametrize("source", ["converted", "own_build"])
def test_cast_pc_apply_matches_porotpu(source, cast_builds):
    """CastPC: f64 in and out, an f32 payload.  Both sides round the same
    f32 V-cycles in another summation order, which the cycle amplifies
    by the blocks' conditioning: 1e-5 relative (f32's epsilon is 1.2e-7)."""
    jp, p, x, want = cast_builds
    assert type(jp.pc).__name__ == "CastPC"
    pc = to_torch(jp.pc) if source == "converted" else p.pc
    assert type(pc).__name__ == "CastPC"
    assert (pc.out_dtype, pc.in_dtype) == (torch.float64, torch.float32)
    # a move to a device keeps the payload's dtype
    floats = [b.dtype for b in pc.to(torch.device("cpu")).buffers() if b.is_floating_point()]
    assert floats and set(floats) == {torch.float32}
    assert want.dtype == np.float64
    with torch.inference_mode():
        got = pc(torch.from_numpy(x))
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert np.isfinite(got.numpy()).all() and err <= 1e-5, err


def _desc(op):
    """Storage description of an operator: class, shape, offsets, ne."""
    name = type(op).__name__
    if name == "Transposed":
        return ("T",) + _desc(op.inner)
    if name == "DIA":
        return ("DIA", tuple(op.shape), tuple(op.offsets), op.ne)
    return (name, tuple(op.shape))


@pytest.mark.parametrize("which", ["solid", "fluid", "schur"])
def test_own_host_setup_matches_porotpu(which, builds):
    jp, p = builds
    jamg, amg = {
        "solid": (jp.pc.solve_s.payload["amg"], p.pc.solve_s.mods["amg"]),
        "fluid": (
            jp.pc.solve_fp.solve_f.payload["amg"],
            p.pc.solve_fp.solve_f.mods["amg"],
        ),
        "schur": (
            jp.pc.solve_fp.solve_S.payload["base"].payload["amg"],
            p.pc.solve_fp.solve_S.mods["base"].mods["amg"],
        ),
    }[which]
    if which == "solid":
        assert len(jamg.levels) >= 2
    assert len(amg.levels) == len(jamg.levels)
    for lv, jlv in zip(amg.levels, jamg.levels):
        assert _desc(lv.A) == _desc(jlv.A)
        assert _desc(lv.P) == _desc(jlv.P)
        assert lv.lmax == pytest.approx(jlv.lmax, rel=1e-12)
        np.testing.assert_allclose(lv.dinv.numpy(), np.asarray(jlv.dinv), rtol=1e-12)
    assert tuple(amg.coarse_inv.shape) == tuple(jamg.coarse_inv.shape)
    np.testing.assert_allclose(
        amg.coarse_inv.numpy(), np.asarray(jamg.coarse_inv),
        rtol=1e-9, atol=1e-9 * np.abs(np.asarray(jamg.coarse_inv)).max(),
    )


def test_block_pc_moves_with_to(builds):
    """Every array of the solver state is a registered buffer: a dtype move
    reaches all of them."""
    _, p = builds
    bufs = dict(p.pc.named_buffers())
    assert any(k.endswith(".data") for k in bufs) and any("coarse_inv" in k for k in bufs)
    # f64, as porotpu: no transposed layout, every transpose reads A's own
    assert not any("dataT" in k for k in bufs)
    moved = p.pc.to(torch.float32)
    assert all(
        b.dtype == torch.float32 for b in moved.buffers() if b.is_floating_point()
    )
    moved.to(torch.float64)


# -- inner kinds: the same CSR block through porotpu's and the port's builder --

INNER_CASES = {
    "jacobi": dict(method="jacobi"),
    "lu": dict(method="lu"),
    "chebyshev": dict(method="chebyshev", iters=6),
    "cg": dict(method="cg", iters=7),
    "cg+amg": dict(method="cg+amg", iters=5, amg_coarse_size=100),
    # above the dense cap "lu" turns into cg+amg at lu_fallback_iters
    "lu_over_cap": dict(method="lu", lu_max_size=100, lu_fallback_iters=3),
}


@pytest.fixture(scope="module")
def solid_block(builds):
    """porotpu's BC-applied, padded solid preconditioner block with its
    near-nullspace and node coordinates (swelling-3d N=3, 1152 rows)."""
    jp, _ = builds
    _, Pb, _, (bc_dofs, _) = jp._bc_applied_blocks()
    ns, ns_p, dim = jp.ns, jp.ns_p, jp.mesh.dim
    space = jp.W.space("s")
    B = jp._rigid_modes_padded(space, ns, ns_p, 0, bc_dofs)
    xyz = jp._padded_coords(space, (ns_p - ns) // dim)
    return Pb[("s", "s")].tocsr(), dict(dofs_per_node=dim, near_nullspace=B, coords=xyz)


@pytest.mark.parametrize("case", list(INNER_CASES))
def test_inner_kind_matches_porotpu_f64(case, solid_block):
    from porotpu.precond.inner import InnerConfig as JConfig
    from porotpu.precond.inner import build_inner_solver as jbuild
    from porotpu_torch.precond.inner import InnerConfig, build_inner_solver

    A, kw = solid_block
    js = jbuild(A, JConfig(**INNER_CASES[case]), dtype=jnp.float64, **kw)
    ts = build_inner_solver(A, InnerConfig(**INNER_CASES[case]), dtype=torch.float64, **kw)
    assert ts.kind == js.kind and ts.iters == js.iters
    if case == "lu_over_cap":
        assert ts.kind == "cg+amg" and ts.iters == 3
    x = np.random.default_rng(5).normal(size=A.shape[0])
    want = np.asarray(jax.jit(lambda o, v: o(v))(js, jnp.asarray(x)))
    with torch.inference_mode():
        got = ts(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= 1e-12, err


@pytest.mark.parametrize("kind", ["cg", "cg+amg"])
def test_cg_inner_kinds_on_zero_rhs_return_zeros(kind, solid_block):
    from porotpu_torch.precond.inner import InnerConfig, build_inner_solver

    A, kw = solid_block
    ts = build_inner_solver(A, InnerConfig(method=kind, iters=4, amg_coarse_size=100),
                            dtype=torch.float64, **kw)
    with torch.inference_mode():
        y = ts(torch.zeros(A.shape[0], dtype=torch.float64))
    assert torch.equal(y, torch.zeros_like(y))


# -- the setup's row-blocked sparse products (precond/amg.py:matmul) ----------


@pytest.fixture
def blocked(monkeypatch):
    """A row block a 50 multiply-adds, up to 16 blocks (4 threads' worth),
    whatever cores this host has; tracing on."""
    from porotpu_torch.precond import amg

    monkeypatch.setattr(amg, "host_threads", lambda: 4)
    monkeypatch.setattr(amg, "_BLOCK_WORK", 50)
    trace.disable()
    trace.reset()
    trace.enable()
    yield amg
    trace.disable()
    trace.reset()


def _same_csr(got, want):
    """``got`` is ``want`` bit for bit: class, shape, dtypes, the stored
    order of every array, and the sorted flag."""
    assert type(got) is type(want) and got.shape == want.shape
    for name in ("data", "indices", "indptr"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.has_sorted_indices == want.has_sorted_indices


def _galerkin_operands(solid_block, amg, monkeypatch):
    """P^T and A P of the first level of the solid block's hierarchy."""
    A, kw = solid_block
    seen = []
    real = amg.matmul

    def record(X, Y):
        seen.append((X, Y))
        return real(X, Y)

    with monkeypatch.context() as m:
        m.setattr(amg, "matmul", record)
        amg.amg_setup(A, kw["dofs_per_node"], kw["near_nullspace"], coarse_size=100,
                      coords=kw["coords"], dtype=torch.float64)
    return seen[3]  # A T, D^-1 (A T), A P, then P^T (A P)


def _empty_rows():
    """Every seventh row and the last ten rows empty."""
    keep = (np.arange(400) % 7 != 0) & (np.arange(400) < 390)
    A = sp.diags(keep.astype(float)) @ sp.random(400, 300, 0.05, format="csr", random_state=1)
    return A.tocsr(), sp.random(300, 120, 0.1, format="csr", random_state=2)


def _cancelling():
    """A row whose product cancels to exact zeros among rows that do not."""
    A = sp.random(300, 200, 0.05, format="lil", random_state=7)
    A[10, :] = 0.0
    A[10, 3], A[10, 5] = 1.0, -1.0
    B = sp.random(200, 150, 0.1, format="lil", random_state=8)
    B[5, :] = B[3, :]
    return A.tocsr(), B.tocsr()


MATMUL_CASES = {
    "galerkin_unsorted": None,
    "empty_rows": _empty_rows,
    "more_blocks_than_rows": lambda: (
        sp.random(3, 500, 0.5, format="csr", random_state=3),
        sp.random(500, 80, 0.2, format="csr", random_state=4)),
    "row_cancels_to_zero": _cancelling,
    "float32": lambda: (
        sp.random(500, 400, 0.02, format="csr", dtype=np.float32, random_state=5),
        sp.random(400, 300, 0.05, format="csr", dtype=np.float32, random_state=6)),
    "under_threshold": lambda: (
        sp.random(20, 20, 0.1, format="csr", random_state=9),
        sp.random(20, 20, 0.1, format="csr", random_state=10)),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_row_blocked_matmul_is_scipys(case, blocked, solid_block, monkeypatch):
    amg = blocked
    if case == "galerkin_unsorted":
        A, B = _galerkin_operands(solid_block, amg, monkeypatch)
        trace.reset()
    else:
        A, B = MATMUL_CASES[case]()
    work = np.diff(B.tocsr().indptr)[A.tocsr().indices].sum()
    assert (work < 2 * amg._BLOCK_WORK) == (case == "under_threshold")
    want = A @ B
    got = amg.matmul(A, B)
    _same_csr(got, want)
    row_blocked = trace.counts().get(trace.ROW_BLOCKED, 0)
    assert row_blocked == (0 if case == "under_threshold" else 1)
    assert trace.totals()[trace.GALERKIN].count == 1
    if case == "galerkin_unsorted":
        assert not want.has_sorted_indices
    if case == "empty_rows":
        assert (np.diff(want.indptr) == 0).sum() >= 60
    if case == "row_cancels_to_zero":
        assert want.indptr[11] == want.indptr[10]
    if case == "float32":
        assert got.dtype == np.float32


@pytest.mark.parametrize("aggregation", ["boxes", "greedy"])
def test_row_blocked_hierarchy_is_the_whole_products(aggregation, blocked, solid_block,
                                                      monkeypatch):
    """``amg_setup`` with its products in row blocks builds the hierarchy
    it builds with each product whole, bit for bit: every level's host A
    and P as handed to ``device_matrix``, the stored operators, dinv, lmax
    and the coarse inverse."""
    amg = blocked
    A, kw = solid_block
    args = dict(dofs_per_node=kw["dofs_per_node"], B=kw["near_nullspace"], coarse_size=100,
                coords=kw["coords"] if aggregation == "boxes" else None, dtype=torch.float64)

    def build(block_work):
        seen = []
        real = amg.device_matrix

        def record(M, *a, **k):
            seen.append(M)
            return real(M, *a, **k)

        with monkeypatch.context() as m:
            m.setattr(amg, "_BLOCK_WORK", block_work)
            m.setattr(amg, "device_matrix", record)
            return amg.amg_setup(A, **args), seen

    whole, whole_csr = build(10**18)
    assert trace.counts() == {}
    trace.reset()
    mine, mine_csr = build(50)
    assert len(mine.levels) == len(whole.levels) >= 1
    assert len(mine_csr) == len(whole_csr) == 2 * len(whole.levels)
    for got, want in zip(mine_csr, whole_csr):
        _same_csr(got, want)
    assert [lv.lmax for lv in mine.levels] == [lv.lmax for lv in whole.levels]
    got, want = mine.state_dict(), whole.state_dict()
    assert list(got) == list(want) and any(k.endswith("dinv") for k in got)
    assert "coarse_inv" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # each level smooths P (A T, then D^-1 A T) and forms P^T (A P): all
    # four of two blocks' work or more, each in row blocks
    products = trace.totals()[trace.GALERKIN].count
    assert products == 4 * len(mine.levels)
    assert trace.counts()[trace.ROW_BLOCKED] == products
    assert all(r.name == trace.AMG_SETUP for r in (trace.records()[x.parent]
               for x in trace.records() if x.name == trace.GALERKIN))

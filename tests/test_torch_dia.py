"""Port parity: the plain versions of kernels K1, K2 and K3 and the DIA/
Transposed/Dense/ELL/FieldMatrix operators of porotpu_torch against
porotpu on the same inputs.

The plain versions are held against the Pallas kernels in interpret mode,
in f32, to 1e-5 of max|y| (f32 rounding over up to ~1000 terms): K1's
(``dia_mv_ref``) and K3's (``dia_mv_padded_ref``, on the padded input)
against porotpu/ops/pallas_dia.py:mv, K2's (``dia_rmv_ref``) against
porotpu/ops/pallas_dia.py:rmv.  The operators are held against porotpu's
on the same CSR in f64 to 1e-12 relative, their transposes to 1e-13 (the
two differ only in summation order).  The CUDA kernels themselves are
tested on the card by tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from porotpu.ops import pallas_dia
from porotpu.ops.dia import DIA as JDIA
from porotpu.ops.dia import device_matrix as jdevice_matrix
from porotpu_torch.convert import to_torch
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.ops import dia_kernel
from porotpu_torch.ops.dia import DIA, Dense, Transposed, device_matrix
from porotpu_torch.ops.sparse import ELL, ELL_PRODUCTS, FieldMatrix
from porotpu_torch.tools.dia_microbench import banded_csr
from torch_k1_cases import (  # noqa: F401 (one_blas_thread: a fixture)
    CSR_CASES, EDGE_CASES, K1_CASES, K2_CPU_CASES, banded_random, csr_case, offset_case,
    one_blas_thread, rmv_case, small_build,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def build():
    return small_build()


# The Pallas kernel's interpret cost grows with its diagonal count (each
# band is traced and lowered in Python): on the two wide sets of the N=3
# build, hold every STRIDE-th band of the operator's own offsets, the
# outermost two kept.  The transposed inner set keeps its layout (dataT on
# negated offsets, 128 inputs -> 1152 outputs); the card holds K1 against
# the plain version on every band (tests/test_torch_gpu.py).
STRIDE = {"solid_block_233": 4, "transposed_inner_714": 12}


@pytest.mark.parametrize("case", K1_CASES)
def test_dia_mv_ref_matches_pallas_interpret(case, build):
    data, offs, x, nrows = offset_case(case, build)
    if case in STRIDE:
        keep = sorted(set(range(0, len(offs), STRIDE[case])) | {len(offs) - 1})
        data, offs = data[keep], tuple(offs[k] for k in keep)
    data = data.astype(np.float32)
    x = x.astype(np.float32)
    y = dia_kernel.dia_mv_ref(torch.from_numpy(data), offs, torch.from_numpy(x), nrows)
    # the Pallas kernel takes ne == nrows: zero-extend a shorter input
    xe = np.zeros(nrows, np.float32)
    xe[: x.size] = x
    ref = np.asarray(
        pallas_dia.mv(jnp.asarray(data), offs, jnp.asarray(xe), nrows, interpret=True)
    )
    assert y.dtype == torch.float32 and y.shape == (nrows,)
    err = np.abs(y.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("case", CSR_CASES)
def test_dia_matches_porotpu_f64(case):
    A, emb = csr_case(case)
    D = DIA.from_csr(A, torch.float64, col_emb=emb, store_transpose=True)
    J = JDIA.from_csr(A, jnp.float64, col_emb=emb, store_transpose=True)
    assert D.offsets == J.offsets and D.ne == J.ne and D.shape == J.shape
    # porotpu stores dataT for f32 only: every f64 transpose reads A's layout
    assert D.dataT is None and J.dataT is None
    rng = np.random.default_rng(6)
    x = rng.normal(size=A.shape[1])
    r = rng.normal(size=A.shape[0])
    y = D.matvec(torch.from_numpy(x)).numpy()
    yt = D.rmatvec(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(y, np.asarray(J.matvec(jnp.asarray(x))), rtol=1e-12, atol=0)
    np.testing.assert_allclose(yt, np.asarray(J.rmatvec(jnp.asarray(r))), rtol=1e-13, atol=0)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)
    np.testing.assert_allclose(yt, A.T @ r, rtol=1e-12)
    np.testing.assert_allclose(D.to_dense(), A.toarray(), rtol=1e-12)
    # the same object carried across from porotpu gives the same products
    C = to_torch(J)
    np.testing.assert_allclose(C.matvec(torch.from_numpy(x)).numpy(), y, rtol=1e-12)
    np.testing.assert_allclose(C.rmatvec(torch.from_numpy(r)).numpy(), yt, rtol=1e-12)


@pytest.mark.parametrize("case", CSR_CASES)
def test_dia_transposed_layout_matches_porotpu_f32(case):
    """f32 stores dataT as porotpu does, and its transpose (K1 on dataT)
    agrees with porotpu's."""
    A, emb = csr_case(case)
    D = DIA.from_csr(A, torch.float32, col_emb=emb, store_transpose=True)
    J = JDIA.from_csr(A, jnp.float32, col_emb=emb, store_transpose=True)
    assert D.dataT is not None and J.dataT is not None
    np.testing.assert_array_equal(D.dataT.numpy(), np.asarray(J.dataT))
    r = np.random.default_rng(6).normal(size=A.shape[0]).astype(np.float32)
    yt = D.rmatvec(torch.from_numpy(r)).numpy()
    want = np.asarray(J.rmatvec(jnp.asarray(r)))
    assert np.abs(yt - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", K2_CPU_CASES)
def test_dia_rmv_ref_matches_pallas_interpret(case, monkeypatch):
    """K2's plain version against the TPU transpose kernel.  The 2048-row
    case runs the kernel with 8-row tiles, so that the bands cross tile
    edges and the kernel's edge-slab combine is exercised."""
    data, offs, x, n = rmv_case(case, None)
    data = data.astype(np.float32)
    x = x.astype(np.float32)
    y = dia_kernel.dia_rmv_ref(torch.from_numpy(data), offs, torch.from_numpy(x), n)
    if n == 2048:
        monkeypatch.setattr(pallas_dia, "T_MAX", 8)
    pallas_dia._rkernel_call.cache_clear()
    try:
        ref = np.asarray(
            pallas_dia.rmv(jnp.asarray(data), offs, jnp.asarray(x), n, interpret=True)
        )
    finally:
        pallas_dia._rkernel_call.cache_clear()
    assert y.dtype == torch.float32 and y.shape == (n,)
    err = np.abs(y.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize(
    "nrows,ne,offs",
    [
        (50, 30, (-4, 0, 3, 20)),  # output shorter than the rows
        (30, 50, (-4, 0, 3, 20)),  # output longer than the rows
        (30, 40, (-60, -31, 0, 35, 90)),  # bands with no row inside [0, ne)
        (30, 40, ()),  # no diagonals
        (30, 0, (-4, 0, 3)),  # empty output
    ],
    ids=["ne_lt_nrows", "ne_gt_nrows", "far_bands", "no_diagonals", "empty_output"],
)
def test_dia_rmv_ref_matches_dense(nrows, ne, offs):
    """K2's plain version against the dense transpose of the band it reads:
    A[i, i + o_d] = data[d, i] over the columns inside [0, ne)."""
    rng = np.random.default_rng(16)
    data = rng.normal(size=(len(offs), nrows))
    x = rng.normal(size=nrows)
    A = np.zeros((nrows, ne))
    for d, o in enumerate(offs):
        i = np.arange(max(0, -o), max(0, min(nrows, ne - o)))
        A[i, i + o] = data[d, i]
    y = dia_kernel.dia_rmv_ref(torch.from_numpy(data), offs, torch.from_numpy(x), ne)
    assert y.dtype == torch.float64 and y.shape == (ne,)
    np.testing.assert_allclose(y.numpy(), A.T @ x, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize(
    "n,offs", [(1024, tuple(range(-7, 8))), (2048, (-300, -129, -42, 0, 5, 130, 301))]
)
def test_dia_mv_padded_ref_matches_pallas_interpret(n, offs):
    """K3's plain version on the padded input against the TPU kernel K1 on
    the unpadded one (K3's TPU prototype has no interpret mode)."""
    rng = np.random.default_rng(14)
    data = rng.normal(size=(len(offs), n)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    lo, hi = dia_kernel.pads(offs)
    xpad = torch.from_numpy(np.concatenate([np.zeros(lo, np.float32), x, np.zeros(hi, np.float32)]))
    y = dia_kernel.dia_mv_padded_ref(torch.from_numpy(data), offs, xpad)
    ref = np.asarray(pallas_dia.mv(jnp.asarray(data), offs, jnp.asarray(x), n, interpret=True))
    assert y.dtype == torch.float32 and y.shape == (n,)
    err = np.abs(y.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


def test_banded_csr_matches_plain_versions():
    """The cuSPARSE yardstick's matrix (a torch CSR tensor) computes the
    functions of K1 and K2 on a rectangular band."""
    rng = np.random.default_rng(15)
    nrows, ncols, offs = 40, 70, (-9, -2, 0, 3, 31)
    data = torch.from_numpy(rng.normal(size=(len(offs), nrows)))
    x = torch.from_numpy(rng.normal(size=ncols))
    r = torch.from_numpy(rng.normal(size=nrows))
    y = banded_csr(data, offs, ncols) @ x
    yt = banded_csr(data, offs, ncols, transpose=True) @ r
    torch.testing.assert_close(y, dia_kernel.dia_mv_ref(data, offs, x, nrows), rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(yt, dia_kernel.dia_rmv_ref(data, offs, r, ncols), rtol=1e-13, atol=1e-13)


def test_transposed_dense_ell_match_porotpu_f64():
    rng = np.random.default_rng(4)
    nrow, ncol = 40, 120
    emb = np.sort(rng.choice(ncol, size=nrow, replace=False))
    rows, cols, vals = [], [], []
    for i in range(nrow):
        j = np.clip(emb[i] + np.arange(-2, 3), 0, ncol - 1)
        cols.append(j)
        rows.append(np.full(j.size, i))
        vals.append(rng.normal(size=j.size))
    M = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nrow, ncol),
    )
    perm = rng.permutation(150)
    B = banded_random(150, [-2, 0, 2], rng).tocoo()
    B = sp.csr_matrix((B.data, (B.row, perm[B.col])), shape=(150, 150))
    for A, kw, cls in (
        (M, dict(row_emb=emb, max_diags=16), Transposed),
        (B, dict(max_diags=8), Dense),
        (B, dict(max_diags=8, dense_max=100), ELL),
    ):
        dev = device_matrix(A, torch.float64, **kw)
        jdev = jdevice_matrix(A, jnp.float64, **kw)
        assert isinstance(dev, cls) and type(jdev).__name__ == cls.__name__
        x = rng.normal(size=A.shape[1])
        y = rng.normal(size=A.shape[0])
        for got, want in (
            (dev.matvec(torch.from_numpy(x)), jdev.matvec(jnp.asarray(x))),
            (dev.rmatvec(torch.from_numpy(y)), jdev.rmatvec(jnp.asarray(y))),
            (to_torch(jdev).matvec(torch.from_numpy(x)), jdev.matvec(jnp.asarray(x))),
        ):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        np.testing.assert_allclose(dev.to_dense(), A.toarray(), rtol=1e-12)


def test_fieldmatrix_matches_porotpu_f64():
    """The N=3 outer operator: the port's own build and porotpu's build of
    the same problem, on one vector."""
    from porotpu.models import benchmarks as jbench

    ov = dict(BENCH_OVERRIDES, dtype="float64")
    p = swelling_3d(3, overrides=ov, device="cpu")
    p._build_operators()
    jp = jbench.swelling_3d(3, overrides=ov)
    jp._build_operators()
    assert isinstance(p.A_dev, FieldMatrix)
    assert sorted(p.A_dev.blocks.keys()) == sorted(r + c for r, c in jp.A_dev.blocks)
    x = np.random.default_rng(7).normal(size=sum(p.padded_sizes))
    want = np.asarray(jax.jit(lambda A, v: A.matvec(v))(jp.A_dev, jnp.asarray(x)))
    for op in (p.A_dev, to_torch(jp.A_dev)):
        got = op.matvec(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_ell_transpose_gathers_its_transposed_layout():
    """ELL's transpose is the gather on the transposed layout, stored with
    the matrix or, on the CPU only, built on the fly: both equal bit for
    bit, and A^T y to 1e-12 of max|y|."""
    A = sp.random(300, 70, density=0.05, random_state=5, format="csr")
    y = np.random.default_rng(6).normal(size=300)
    stored = ELL.from_csr(A, torch.float64, store_transpose=True)
    bare = ELL.from_csr(A, torch.float64)
    assert stored.dataT is not None and bare.dataT is None
    got = stored.rmatvec(torch.from_numpy(y))
    assert torch.equal(got, bare.rmatvec(torch.from_numpy(y)))
    want = A.T @ y
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert bare.dataT is None  # the CPU transposes on the fly and keeps nothing


def _wide_sparse():
    """A 300 x 280 matrix with an empty row and column, a row and a column
    of more than 256 entries."""
    A = sp.random(300, 280, density=0.03, random_state=9, format="lil")
    A[7, :] = np.arange(1.0, 281.0)
    A[:, 3] = np.arange(1.0, 301.0)[:, None]
    A[5, :] = 0
    A[:, 9] = 0
    return A.tocsr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("product", ["matvec", "rmatvec"])
def test_ell_stores_int32_columns_and_gathers_as_int64(product, dtype):
    """``ELL.from_csr`` stores int32 columns in both layouts; the plain
    product on them equals the int64 gather bit for bit, on rows wider than
    256 and an empty row, and counts as one plain product."""
    A = _wide_sparse()
    E = ELL.from_csr(A, dtype, store_transpose=True)
    assert E.cols.dtype == E.colsT.dtype == torch.int32
    data, cols = (E.data, E.cols) if product == "matvec" else (E.dataT, E.colsT)
    assert data.shape[1] > 256 and (data == 0).all(1).any()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=A.shape[product == "matvec"]))
    x = x.to(dtype)
    dia_kernel.reset_counts()
    got = getattr(E, product)(x)
    assert dia_kernel.ELL_COUNTS == {"ell_mv": 0, "ell_rmv": 0, "plain": 1}
    assert torch.equal(got, (data * x[cols.long()]).sum(1))


@pytest.mark.parametrize("move", ["to_float32", "pickle"])
def test_ell_move_rebuilds_its_product_keys(move):
    """A move or a copy of an ELL counts its products under its own dtype
    and shape, keeps int32 columns and computes what the original does."""
    import pickle

    A = _wide_sparse()
    E = ELL.from_csr(A, torch.float64, store_transpose=True)
    F = E.to(torch.float32) if move == "to_float32" else pickle.loads(pickle.dumps(E))
    dt = "float32" if move == "to_float32" else "float64"
    x = torch.from_numpy(np.random.default_rng(4).normal(size=A.shape[1])).to(F.data.dtype)
    y = torch.from_numpy(np.random.default_rng(5).normal(size=A.shape[0])).to(F.data.dtype)
    ELL_PRODUCTS.clear()
    got = F.matvec(x), F.rmatvec(y)
    n, L = F.data.shape
    assert dict(ELL_PRODUCTS) == {("matvec", dt, n, L): 1, ("rmatvec", dt, n, L): 1}
    assert F.cols.dtype == F.colsT.dtype == torch.int32
    want = (E.data.to(F.data.dtype) * x[E.cols.long()]).sum(1), (
        E.dataT.to(F.data.dtype) * y[E.colsT.long()]).sum(1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_dispatch_counts_plain_sweeps():
    A = banded_random(64, [-3, 0, 5], np.random.default_rng(8))
    for dtype in (torch.float32, torch.float64):  # rmatvec via dataT, then via A's layout
        D = DIA.from_csr(A, dtype, store_transpose=True)
        dia_kernel.reset_counts()
        D.matvec(torch.ones(64, dtype=dtype))
        D.rmatvec(torch.ones(64, dtype=dtype))
        assert dia_kernel.COUNTS == {"dia_mv": 0, "dia_rmv": 0, "dia_mv_padded": 0, "plain": 2}


@pytest.mark.parametrize("n, offset, path", [(64, 0, "vector"), (63, 0, "scalar"),
                                             (64, 1, "scalar")])
def test_banded_counters_count_stored_nonzero_and_k1_path(n, offset, path):
    """A hand-built f64 DIA, its zeros known: the band's overhang and every
    seventh value of the main diagonal.  Two products and a transpose add
    exactly their stored values and nonzeros; K1's values go to the vector
    path on an even length and an aligned input, else to the scalar path
    (an odd length, or an input 8 bytes off 16-byte alignment);
    ``reset_counts`` zeroes them."""
    from porotpu_torch.utils import trace

    offsets = (-2, 0, 3)
    rows = np.arange(n)
    data = np.zeros((len(offsets), n))
    for d, o in enumerate(offsets):
        inside = (rows + o >= 0) & (rows + o < n)
        data[d, inside] = 1.0 + rows[inside]
    data[1, ::7] = 0.0
    nnz = int(np.count_nonzero(data))
    D = DIA(torch.from_numpy(data), offsets, n, n)
    assert D.nnz == nnz == DIA.from_csr(sp.csr_matrix(D.to_dense())).nnz
    x = torch.ones(n + offset, dtype=torch.float64)[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    dia_kernel.reset_counts()
    D.matvec(x)
    D.matvec(x)
    D.rmatvec(x)
    stored = len(offsets) * n
    assert dia_kernel.STORED == {"dia_mv": 2 * stored, "dia_rmv": stored}
    assert dia_kernel.NONZERO == {"dia_mv": 2 * nnz, "dia_rmv": nnz}
    other = "scalar" if path == "vector" else "vector"
    assert dia_kernel.K1_PATH == {path: 2 * stored, other: 0}
    band = trace.banded_totals()
    assert (band.stored, band.nonzero) == (3 * stored, 3 * nnz)
    assert band.fill == 100.0 * (stored - nnz) / stored
    assert band.k1_scalar_share == (100.0 if path == "scalar" else 0.0)
    dia_kernel.reset_counts()
    assert dia_kernel.STORED == dia_kernel.NONZERO == {"dia_mv": 0, "dia_rmv": 0}
    assert dia_kernel.K1_PATH == {"vector": 0, "scalar": 0}
    assert trace.banded_totals() == trace.Banded()
    assert trace.Banded().fill is None and trace.Banded().k1_scalar_share is None


# (nd, rows) of every banded operator the N=13 bench solve launches K1 or K2
# on (chip_smoke.py's launches by operator; PERF.md), square in the lattice
N13_OPERATORS = [
    (233, 59136), (195, 59136), (454, 59136), (402, 59136), (681, 4480), (617, 4480),
    (65, 59136), (65, 2816), (123, 2816), (1, 59136), (15, 2816), (1, 2816),
]
PLAN_SHAPES = [(nd, n, n) for nd, n in N13_OPERATORS] + [
    shape for nd, nrows, ne, _ in EDGE_CASES.values()
    for shape in ((nd, nrows, ne), (nd, ne, nrows))  # K1 (n_out, n_in), K2
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_plan_covers_every_diagonal_once(dtype):
    """On every N=13 operator shape and every edge shape: the groups split
    the diagonals (each in exactly one group), the cluster is at most 8 and
    divides the tile, the block's shared memory fits without an attribute
    call (and so the H100's 227 KB), and the grid has a block.  The heavy
    N=13 operators fill the card: at least MIN_WARPS_PER_SM warps an SM, or
    the largest cluster."""
    for nd, n_out, n_in in PLAN_SHAPES:
        plan = dia_kernel.launch_plan(nd, n_out, n_in, dtype)
        covered = [d for lo, hi in plan.group_ranges(nd) for d in range(lo, hi)]
        assert covered == list(range(nd)), (nd, n_out, plan)
        assert plan.cluster in (1, 2, 4, 8) and plan.tile % plan.cluster == 0
        assert plan.smem_bytes <= dia_kernel.SHARED_MEMORY_PER_BLOCK <= 227 * 1024
        assert plan.blocks == -(-n_out // plan.tile) * plan.cluster >= 1
        assert plan.tile == 32 * dia_kernel.CHUNKS * 16 // dtype.itemsize
        assert plan.vec == (n_out % (16 // dtype.itemsize) == 0 == n_in % (16 // dtype.itemsize))
        if nd * n_out >= 2_000_000:
            warps_per_sm = plan.blocks * plan.warps / dia_kernel.SM_COUNT
            assert warps_per_sm >= dia_kernel.MIN_WARPS_PER_SM or plan.cluster == 8, plan

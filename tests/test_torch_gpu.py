"""Kernels K1, K2 and K3 on the card: each CUDA kernel against its plain
PyTorch version, f32 to 1e-5 and f64 to 1e-12 of max|y| (summation order
only), on the N=3 and test_dia offset sets and on the launch plan's edge
shapes; K1 and K2 also launch twice bitwise equal, take an unaligned
input and refuse unaligned data.  The solid and fluid-pressure drivers at
N=3 in f64 launch K1, take no plain version and match their CPU runs.
A row mesh's local halo products (K1 on a rank's window, K2 over it,
offsets shifted by the halo) match their plain versions, and the split
halo matvec (interior launch, then the boundary fix-ups) the unsplit one.  ELL's transpose
(a gather on its transposed layout) is bitwise repeatable on the card.  The ELL
kernel (``csrc/ell_mv.cu``) matches the plain gather, f32 to 1e-5 and f64 to
1e-12 of max|y|, launches twice bitwise equal at the benchmark cells' operator
shapes and at every lane-group edge, takes no plain product, and refuses a
bad input.

Every test here needs a CUDA card and skips without one.  This file
imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from porotpu_torch.ops import dia_kernel
from porotpu_torch.ops.dia import DIA, Transposed
from porotpu_torch.ops.sparse import ELL, EllLaunch, ell_mv_ref, ell_transpose
from porotpu_torch.tools.dia_microbench import ELL_SHAPES, random_ell
from torch_k1_cases import (
    EDGE_CASES, K1_CASES, K2_CASES, csr_case, edge_case, offset_case, rmv_case, small_build,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def build():
    return small_build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_cuda_matches_plain(case, dtype, tol, build, cuda_device):
    data, offs, x, nrows = offset_case(case, build)
    data = torch.as_tensor(data, dtype=dtype, device=cuda_device)
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    before = dia_kernel.COUNTS["dia_mv"]
    y = dia_kernel.dia_mv(data, offs_dev, x)
    torch.cuda.synchronize()
    assert dia_kernel.COUNTS["dia_mv"] == before + 1
    ref = dia_kernel.dia_mv_ref(data, offs, x, nrows)
    err = ((y - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_cuda_matches_plain(case, dtype, tol, build, cuda_device):
    data, offs, x, ne = rmv_case(case, build)
    data = torch.as_tensor(data, dtype=dtype, device=cuda_device)
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    before = dia_kernel.COUNTS["dia_rmv"]
    y = dia_kernel.dia_rmv(data, offs_dev, x, ne)
    torch.cuda.synchronize()
    assert dia_kernel.COUNTS["dia_rmv"] == before + 1 and y.shape == (ne,)
    ref = dia_kernel.dia_rmv_ref(data, offs, x, ne)
    err = ((y - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_k1_k2_edge_shapes_match_plain(case, dtype, tol, cuda_device):
    """K1 and K2 at the launch plan's edge shapes, each launched twice: the
    two results are bitwise equal and match the plain version."""
    data, offs, x, xt, ne = edge_case(case)
    data, x, xt = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (data, x, xt))
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    nrows = data.shape[1]
    for y1, y2, ref in (
        (dia_kernel.dia_mv(data, offs_dev, x), dia_kernel.dia_mv(data, offs_dev, x),
         dia_kernel.dia_mv_ref(data, offs, x, nrows)),
        (dia_kernel.dia_rmv(data, offs_dev, xt, ne), dia_kernel.dia_rmv(data, offs_dev, xt, ne),
         dia_kernel.dia_rmv_ref(data, offs, xt, ne)),
    ):
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        assert y1.shape == ref.shape
        scale = ref.abs().max().item()
        assert (y1 - ref).abs().max().item() <= tol * scale


@pytest.mark.parametrize("kernel", ["dia_mv", "dia_rmv"])
def test_k1_k2_deterministic_and_unaligned_input(kernel, cuda_device):
    """A cluster launch (600 diagonals on 8 tiles) twice gives bitwise equal
    results, and an input that is not 16-byte aligned (read with masked
    scalar loads) gives the same bits as an aligned copy."""
    data, offs, x, xt, ne = edge_case("nd_over_groups")
    data = torch.as_tensor(data, dtype=torch.float32, device=cuda_device)
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    inp = torch.as_tensor(x if kernel == "dia_mv" else xt, dtype=torch.float32, device=cuda_device)
    assert dia_kernel.launch_plan(len(offs), ne, data.shape[1], torch.float32).cluster == 8
    shifted = torch.empty(inp.numel() + 1, dtype=inp.dtype, device=cuda_device)[1:]
    shifted.copy_(inp)
    assert shifted.data_ptr() % 16 != 0

    def run(v):
        if kernel == "dia_mv":
            return dia_kernel.dia_mv(data, offs_dev, v)
        return dia_kernel.dia_rmv(data, offs_dev, v, ne)

    ys = [run(inp), run(inp), run(shifted)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


def test_k1_k2_reject_unaligned_data(cuda_device):
    nd, n = 3, 256
    flat = torch.ones(nd * n + 1, device=cuda_device)
    data = flat[1:].view(nd, n)
    assert data.is_contiguous() and data.data_ptr() % 16 != 0
    offs = torch.tensor([-1, 0, 1], dtype=torch.int32, device=cuda_device)
    x = torch.ones(n, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dia_kernel.dia_mv(data, offs, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dia_kernel.dia_rmv(data, offs, x, n)


def test_k3_cuda_matches_plain_and_k1(cuda_device):
    rng = np.random.default_rng(10)
    n, offs = 5000, tuple(range(-40, 41)) + (300,)
    data = torch.as_tensor(rng.normal(size=(len(offs), n)), dtype=torch.float32,
                           device=cuda_device)
    x = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda_device)
    lo, hi = dia_kernel.pads(offs)
    xpad = torch.nn.functional.pad(x, (lo, hi))
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    before = dia_kernel.COUNTS["dia_mv_padded"]
    y = dia_kernel.dia_mv_padded(data, offs, offs_dev, xpad)
    torch.cuda.synchronize()
    assert dia_kernel.COUNTS["dia_mv_padded"] == before + 1
    for ref in (dia_kernel.dia_mv_padded_ref(data, offs, xpad), dia_kernel.dia_mv(data, offs_dev, x)):
        err = ((y - ref).abs().max() / ref.abs().max()).item()
        assert err <= 1e-5, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_cuda_dia_operators(dtype, cuda_device):
    """DIA and Transposed products on the card: forward products launch K1,
    transposes K1 on dataT (f32) or K2 (f64), none the plain version."""
    A, emb = csr_case("col_emb")
    D = DIA.from_csr(A, dtype, col_emb=emb, store_transpose=True).to(cuda_device)
    rng = np.random.default_rng(9)
    x = rng.normal(size=A.shape[1])
    r = rng.normal(size=A.shape[0])
    dia_kernel.reset_counts()
    y = D.matvec(torch.as_tensor(x, dtype=dtype, device=cuda_device))
    yt = Transposed(D).matvec(torch.as_tensor(r, dtype=dtype, device=cuda_device))
    k2 = int(dtype == torch.float64)
    assert dia_kernel.COUNTS == {"dia_mv": 2 - k2, "dia_rmv": k2, "dia_mv_padded": 0, "plain": 0}
    rtol = 1e-12 if k2 else 1e-5
    for got, want in ((y, A @ x), (yt, A.T @ r)):
        got = got.cpu().double().numpy()
        assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_k1_rejects_bad_input(cuda_device):
    data = torch.ones((2, 8), device=cuda_device)
    offs = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        dia_kernel.dia_mv(data, offs, torch.ones(8, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        dia_kernel.dia_mv(data, offs[:1], torch.ones(8, device=cuda_device))
    # a DIA without dataT transposes through K2 (it raised before K2 existed)
    D = DIA(data, (0, 1), 8, 8).to(cuda_device)
    yt = D.rmatvec(torch.ones(8, device=cuda_device))
    torch.testing.assert_close(yt.cpu(), torch.tensor([1.0] + [2.0] * 7))
    with pytest.raises(ValueError, match="input of length"):
        dia_kernel.dia_rmv(data, offs, torch.ones(9, device=cuda_device), 8)
    assert dia_kernel.dia_rmv(data, offs, torch.ones(8, device=cuda_device), 0).shape == (0,)
    assert dia_kernel.dia_rmv(data[:0], offs[:0], torch.ones(8, device=cuda_device), 5).eq(0).all()
    with pytest.raises(TypeError):
        dia_kernel.dia_mv_padded(data.double(), (0, 1), offs, torch.ones(9, dtype=torch.float64,
                                                                          device=cuda_device))
    with pytest.raises(ValueError, match="xpad has"):
        dia_kernel.dia_mv_padded(data, (0, 1), offs, torch.ones(8, device=cuda_device))


@pytest.mark.parametrize("name", ["solid", "fluid_pressure"])
def test_subsystem_drivers_on_the_card(name, cuda_device):
    """The solid (outer cg + AMG) and fluid-pressure (fgmres + Schur
    fieldsplit) drivers at N=3 in f64: K1 launched and no plain product on
    the card, the count and x of the CPU run (plain versions) to 1e-10."""
    from porotpu_torch.drivers import fluid_pressure, solid

    drv = {"solid": solid, "fluid_pressure": fluid_pressure}[name]
    argv = ["-N", "3", "--dtype", "float64"]
    card = drv.setup(argv)
    assert card.device.type == "cuda"
    dia_kernel.reset_counts()
    its = card.solve()
    counts = dict(dia_kernel.COUNTS)
    cpu = drv.setup(argv + ["--device", "cpu"])
    assert cpu.solve() == its and card.result.converged
    assert counts["dia_mv"] > 0 and counts["plain"] == 0
    x, want = card.result.x.cpu().numpy(), cpu.result.x.numpy()
    assert np.abs(x - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("W", [2, 4])
def test_halo_local_products_on_the_card(W, dtype, tol, cuda_device):
    """Each rank's local halo products on the card against their plain
    versions: K1 on the window [from_left | x_loc | from_right] cut from
    a random vector, offsets shifted by hl, and K2 over the window of
    hl + nloc + hr columns, on the slabs of a random banded operator."""
    from porotpu_torch.ops.dia import halo_matvec_local, halo_rmatvec_local
    from porotpu_torch.parallel import sharding
    from porotpu_torch.tools.shard_walk import SlabMesh

    rng = np.random.default_rng(21)
    n, offs = 8192, (-700, -129, -1, 0, 1, 3, 128, 811)
    hl, hr, nloc = 700, 811, 8192 // W
    D = DIA(torch.from_numpy(rng.normal(size=(len(offs), n))), offs, n, n)
    x = torch.as_tensor(rng.normal(size=n + hl + hr), dtype=dtype)
    for r in range(W):
        sh = sharding.shard_ell(D, SlabMesh(r, W))
        assert sh.dist[0] == "halo" and sh.halo == (hl, hr)
        data = sh.data.to(dtype=dtype, device=cuda_device)
        shift_dev = sh.shift_dev.to(cuda_device)
        window = x[r * nloc : r * nloc + hl + nloc + hr].to(cuda_device)
        y = halo_matvec_local(data, sh.shift, shift_dev, window)
        ref = dia_kernel.dia_mv_ref(data, sh.shift, window, nloc)
        assert ((y - ref).abs().max() / ref.abs().max()).item() <= tol
        xl = window[hl : hl + nloc].contiguous()
        acc = halo_rmatvec_local(data, sh.shift, shift_dev, xl, hl, hr)
        ref = dia_kernel.dia_rmv_ref(data, sh.shift, xl, hl + nloc + hr)
        assert acc.shape == (hl + nloc + hr,)
        assert ((acc - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_halo_matvec_on_the_card(dtype, build, cuda_device, capsys):
    """The split halo matvec (the interior K1 launch on x_loc alone, then
    the hl top and hr bottom rows recomputed from the halos, with the slab
    launch's diagonal groups) against the unsplit one (one K1 launch on the
    window), on the bench's level-0 solid A (N=3 build, 233 bands) as one
    rank's slab with a simulated halo of random values: within dtype
    rounding; prints whether the two are bit for bit equal and their
    largest difference."""
    from porotpu_torch.ops.dia import halo_fixup_local, halo_interior_local, halo_matvec_local

    A = build.pc.solve_s.mods["amg"].levels[0].A
    assert isinstance(A, DIA) and len(A.offsets) == 233 and A.col_emb is None
    offs, nloc = A.offsets, A.nrows
    hl, hr = max(0, -min(offs)), max(0, max(offs))
    assert nloc > hl + hr
    shift = tuple(o + hl for o in offs)
    rng = np.random.default_rng(23)
    data = A.data.to(dtype=dtype, device=cuda_device)
    window = torch.as_tensor(rng.normal(size=hl + nloc + hr), dtype=dtype, device=cuda_device)
    from_left, x_loc, from_right = window[:hl], window[hl : hl + nloc], window[hl + nloc :]
    dev = lambda t: torch.tensor(t, dtype=torch.int32, device=cuda_device)  # noqa: E731
    unsplit = halo_matvec_local(data, shift, dev(shift), window)
    y = halo_interior_local(data, offs, dev(offs), x_loc.contiguous())
    split = halo_fixup_local(y, data[:, :hl].contiguous(), data[:, nloc - hr :].contiguous(),
                             shift, dev(shift), x_loc, from_left, from_right)
    diff = (split - unsplit).abs().max().item()
    with capsys.disabled():
        print(f"\nsplit vs unsplit halo matvec, {dtype}, level-0 A {nloc} rows, "
              f"{len(offs)} bands, hl {hl}, hr {hr}: bit for bit {torch.equal(split, unsplit)}, "
              f"max |diff| {diff:.3e} (max |y| {unsplit.abs().max().item():.3e})")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert diff <= tol * unsplit.abs().max().item()


def test_ell_transpose_on_the_card(cuda_device):
    """ELL's transpose gathers the transposed layout built with the matrix:
    two products on the card are bitwise equal and match the CPU's to
    1e-12; an ELL built without the layout refuses its transpose there."""
    import scipy.sparse as sp

    from porotpu_torch.ops.sparse import ELL

    A = sp.random(3000, 700, density=0.01, random_state=3, format="csr")
    y = torch.from_numpy(np.random.default_rng(4).normal(size=3000))
    E = ELL.from_csr(A, torch.float64, store_transpose=True)
    want = E.rmatvec(y)
    E.to(cuda_device)
    yd = y.to(cuda_device)
    first, second = E.rmatvec(yd), E.rmatvec(yd)
    assert torch.equal(first, second)
    assert ((first.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-12
    bare = ELL.from_csr(A, torch.float64).to(cuda_device)
    with pytest.raises(RuntimeError, match="transposed layout"):
        bare.rmatvec(yd)


def _ell_products(E, product, x, tol, counted):
    """Two launches of ``product`` on the card: counted as kernel launches,
    no plain product, bitwise equal, and the plain gather's to ``tol`` of
    max|y|."""
    before = dict(dia_kernel.ELL_COUNTS)
    first, second = getattr(E, product)(x), getattr(E, product)(x)
    torch.cuda.synchronize()
    assert dia_kernel.ELL_COUNTS == dict(before, **{counted: before[counted] + 2})
    assert torch.equal(first, second)
    data, cols = (E.data, E.cols) if product == "matvec" else (E.dataT, E.colsT)
    ref = ell_mv_ref(data, cols.long(), x)
    err = ((first - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", ELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("product", ["matvec", "rmatvec"])
def test_ell_kernel_matches_plain_at_the_cells_shapes(product, shape, dtype, tol, cuda_device):
    """A x on (data, cols) of the shape, and A^T x on a transposed layout of
    the shape (A's own layout built from it on the host)."""
    n, width, n_in = shape
    data, cols = random_ell(n, width, n_in, seed=n + width)
    if product == "matvec":
        E = ELL(torch.as_tensor(data, dtype=dtype), torch.from_numpy(cols), n_in)
    else:
        dA, cA = ell_transpose(data, cols, n_in)
        E = ELL(torch.as_tensor(dA, dtype=dtype), torch.from_numpy(cA), n,
                torch.as_tensor(data, dtype=dtype), torch.from_numpy(cols))
    E.to(cuda_device)
    assert E.cols.dtype == torch.int32 and (E.colsT is None or E.colsT.dtype == torch.int32)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=n_in), dtype=dtype,
                        device=cuda_device)
    _ell_products(E, product, x, tol, "ell_mv" if product == "matvec" else "ell_rmv")


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                                   128, 129, 300])
def test_ell_kernel_edge_widths_match_plain(width, cuda_device):
    """Every lane group (2 to 32 lanes a row) at and around its edges, on
    row counts that leave a block, a warp and a group part empty."""
    for n in (1, 7, 33, 1001):
        data, cols = random_ell(n, width, 500, seed=width * n)
        E = ELL(torch.from_numpy(data), torch.from_numpy(cols), 500).to(cuda_device)
        x = torch.as_tensor(np.random.default_rng(n).normal(size=500), device=cuda_device)
        _ell_products(E, "matvec", x, 1e-12, "ell_mv")


def test_ell_kernel_refuses_bad_operands(cuda_device):
    data, cols = random_ell(40, 6, 30)
    E = ELL(torch.from_numpy(data), torch.from_numpy(cols), 30).to(cuda_device)
    x = torch.ones(30, dtype=torch.float64, device=cuda_device)
    for bad in (x.float(), x.cpu(), x[:29], torch.ones(60, dtype=torch.float64,
                                                           device=cuda_device)[::2]):
        with pytest.raises(ValueError, match="ell_mv: needs a contiguous"):
            E.matvec(bad)
    d, c = E.data, E.cols
    with pytest.raises(TypeError, match="int32"):
        EllLaunch("ell_mv", d, c.long(), 30)
    with pytest.raises(TypeError, match="float32 or float64"):
        EllLaunch("ell_mv", d.half(), c, 30)
    with pytest.raises(ValueError, match="columns in"):
        EllLaunch("ell_mv", d, c, 20)
    with pytest.raises(ValueError, match="one CUDA device"):
        EllLaunch("ell_mv", d, c.cpu(), 30)

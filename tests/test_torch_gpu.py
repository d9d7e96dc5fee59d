"""Kernels K1, K2 and K3 on the card: each CUDA kernel against its plain
PyTorch version, f32 to 1e-5 and f64 to 1e-12 of max|y| (summation order
only), on the N=3 and test_dia offset sets and on the launch plan's edge
shapes; K1 and K2 also launch twice bitwise equal, take an unaligned
input and refuse unaligned data.

Every test here needs a CUDA card and skips without one.  This file
imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from porotpu_torch.ops import dia_kernel
from porotpu_torch.ops.dia import DIA, Transposed
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

"""ELL storage and the per-field block operator (porotpu/ops/sparse.py).

ELL is the last-resort format of ``device_matrix`` (unbanded blocks).  Its
columns are int32, as porotpu stores them.  On the card a product is one
launch of ``csrc/ell_mv.cu``, checked once when the matrix is moved
there (``EllLaunch``, from ``ELL._apply``); on the CPU it is the plain
version ``ell_mv_ref``, porotpu's gather (``x[cols]``, weighted, summed
over each row).  There is no fallback between the two.  The transpose
product is the same product on a transposed ELL built with the matrix on
the host (``store_transpose``; ``device_matrix`` asks for it where a solve
transposes, the AMG prolongators): a scatter-add (``index_add_``) sums in
an order that changes from run to run on the card, and made two runs of
one solve differ in the last bits.  On the card an ELL built without the
layout refuses its transpose; on the CPU it transposes on the fly.
``ELL_PRODUCTS`` counts the products by (product, dtype, rows, width),
``dia_kernel.ELL_COUNTS`` the kernel's launches and the plain products.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from . import dia_kernel

ELL_PRODUCTS = collections.Counter()


def _ell_arrays(A: sp.csr_matrix):
    """(data f64, cols int32) of the padded rows of a CSR matrix; a row's pad
    slots repeat its own first column with a zero value (the gather stays
    local)."""
    n = A.shape[0]
    counts = np.diff(A.indptr)
    L = max(int(counts.max()) if n else 1, 1)
    data = np.zeros((n, L), dtype=np.float64)
    cols = np.zeros((n, L), dtype=np.int32)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    data[rows, pos] = A.data
    cols[rows, pos] = A.indices
    pad = np.arange(L)[None, :] >= counts[:, None]
    return data, np.where(pad, cols[:, 0:1], cols)


def ell_transpose(data: np.ndarray, cols: np.ndarray, ncols: int):
    """(dataT f64, colsT int32): the ELL arrays of A^T for the ELL arrays of A."""
    n, L = data.shape
    A = sp.csr_matrix(
        (data.ravel(), (np.repeat(np.arange(n), L), cols.ravel())), shape=(n, ncols)
    )
    A.sum_duplicates()
    A.eliminate_zeros()
    return _ell_arrays(A.T.tocsr())


def ell_mv_ref(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ELL kernel: y[i] = sum_j data[i, j] *
    x[cols[i, j]], the gather, product and row sum of porotpu's ELL."""
    return (data * x[cols]).sum(1)


_ELL_FN = {torch.float32: "porotpu_ell_mv_f32", torch.float64: "porotpu_ell_mv_f64"}


class EllLaunch:
    """One ELL product on the card, A x on (data, cols) or A^T x on the
    transposed layout: the operands checked and the kernel chosen when the
    matrix is moved to the card (the kernel takes its lanes a row from the
    width).  A call then allocates y, reads the current stream, makes one
    ctypes call and checks its error code."""

    __slots__ = ("name", "fn", "data", "cols", "n", "width", "n_in", "dtype",
                 "device", "index", "in_shape", "ptrs", "stream")

    def __init__(self, name: str, data: torch.Tensor, cols: torch.Tensor, n_in: int):
        if data.dtype not in _ELL_FN:
            raise TypeError(f"{name}: needs float32 or float64 values, got {data.dtype}")
        if cols.dtype != torch.int32:
            raise TypeError(f"{name}: column indices must be int32, got {cols.dtype}")
        if not (data.is_cuda and cols.device == data.device):
            raise ValueError(f"{name}: values and columns must be on one CUDA device")
        if data.dim() != 2 or cols.shape != data.shape:
            raise ValueError(f"{name}: expects values and columns of one (n, width) shape, "
                             f"got {tuple(data.shape)} and {tuple(cols.shape)}")
        if not (data.is_contiguous() and cols.is_contiguous()):
            raise ValueError(f"{name}: values and columns must be contiguous")
        n, width = data.shape
        if max(n, width, n_in) >= 2**31:
            raise ValueError(f"{name}: sizes beyond int32 indexing")
        if data.numel():
            lo, hi = (int(v) for v in torch.aminmax(cols))
            if lo < 0 or hi >= n_in:
                raise ValueError(f"{name}: columns in [{lo}, {hi}] for an input of {n_in}")
        self.name, self.data, self.cols = name, data, cols
        self.n, self.width, self.n_in = int(n), int(width), int(n_in)
        self.dtype, self.device, self.index = data.dtype, data.device, data.get_device()
        self.in_shape = (self.n_in,)
        self.ptrs = (data.data_ptr(), cols.data_ptr())
        self.fn = getattr(dia_kernel._load(), _ELL_FN[data.dtype])
        self.stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if (x.dtype is not self.dtype or x.get_device() != self.index
                or x.shape != self.in_shape or not x.is_contiguous()):
            raise ValueError(
                f"{self.name}: needs a contiguous {self.dtype} input of shape {self.in_shape} "
                f"on {self.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        y = torch.empty(self.n, dtype=self.dtype, device=self.device)
        err = self.fn(*self.ptrs, self.n, self.width, x.data_ptr(), self.n_in, y.data_ptr(),
                      self.stream(self.index))
        if err:
            raise RuntimeError("{} launch failed: CUDA error {} ({})".format(
                self.name, err, dia_kernel._lib.porotpu_cuda_error_string(err).decode()))
        dia_kernel.ELL_COUNTS[self.name] += 1
        return y


class ELL(nn.Module):
    """Padded-row (ELLPACK) sparse matrix: data (n, L), cols (n, L) int32;
    with the transposed layout, dataT (ncols, LT) and colsT (ncols, LT)
    hold the ELL of A^T, each row's entries in increasing row order of A."""

    dist = None  # None, or ("gather", mesh): rows in slabs, columns global
    col_slab = True

    def __init__(self, data, cols, ncols, dataT=None, colsT=None):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("cols", cols.to(torch.int32))
        self.register_buffer("dataT", dataT)
        self.register_buffer("colsT", None if colsT is None else colsT.to(torch.int32))
        self.ncols = int(ncols)
        self._prepare()

    def _prepare(self):
        """The products' keys in ``ELL_PRODUCTS`` and, for a matrix on the
        card, the kernel's launches (``EllLaunch``); run again wherever the
        buffers move or change dtype (``_apply``)."""
        n, L = self.data.shape
        dt = str(self.data.dtype).removeprefix("torch.")
        self._mv_key, self._rmv_key = ("matvec", dt, n, L), ("rmatvec", dt, n, L)
        self._mv = self._rmv = None
        if self.data.is_cuda:
            self._mv = EllLaunch("ell_mv", self.data, self.cols, self.ncols)
            if self.dataT is not None:
                self._rmv = EllLaunch("ell_rmv", self.dataT, self.colsT, n)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._prepare()
        return self

    def __getstate__(self):
        state = super().__getstate__()
        state["_mv"] = state["_rmv"] = None  # a launch holds the library's functions
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        self._prepare()

    @property
    def shape(self):
        n = self.data.shape[0]
        if self.dist is not None and self.dist[0] == "gather":
            n *= self.dist[1].world
        return (n, self.ncols)

    def set_dist(self, mesh, col_slab: bool):
        """Tag a slab of rows: the matvec gathers a field input, the
        transpose sums over the ranks."""
        self.dist = ("gather", mesh)
        self.col_slab = bool(col_slab)
        return self

    @classmethod
    def from_csr(cls, A: sp.spmatrix, dtype=torch.float32, store_transpose=False) -> "ELL":
        A = A.tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        data, cols = _ell_arrays(A)
        dataT = colsT = None
        if store_transpose:
            dT, colsT = _ell_arrays(A.T.tocsr())
            dataT, colsT = torch.as_tensor(dT, dtype=dtype), torch.from_numpy(colsT)
        return cls(torch.as_tensor(data, dtype=dtype), torch.from_numpy(cols), A.shape[1],
                   dataT, colsT)

    def matvec(self, x):
        ELL_PRODUCTS[self._mv_key] += 1
        if self.dist is not None and self.dist[0] == "gather" and self.col_slab:
            x = self.dist[1].all_gather(x)
        if self._mv is not None:
            return self._mv(x)
        dia_kernel.ELL_COUNTS["plain"] += 1
        return ell_mv_ref(self.data, self.cols, x)

    forward = matvec

    def rmatvec(self, x):
        """A^T x: the product on the transposed layout, summed in a fixed
        order."""
        if self._rmv is not None:
            ELL_PRODUCTS[self._rmv_key] += 1
            y = self._rmv(x)
        else:
            dataT, colsT = self.dataT, self.colsT
            if dataT is None:
                if self.data.is_cuda:
                    raise RuntimeError(
                        "ELL.rmatvec: this matrix was built without its transposed layout; "
                        "build it with ELL.from_csr(store_transpose=True) "
                        "(device_matrix(need_rmatvec=True))"
                    )
                dT, cT = ell_transpose(self.data.double().numpy(), self.cols.numpy(), self.ncols)
                dataT, colsT = torch.as_tensor(dT, dtype=self.data.dtype), torch.from_numpy(cT)
            ELL_PRODUCTS[self._rmv_key] += 1
            dia_kernel.ELL_COUNTS["plain"] += 1
            y = ell_mv_ref(dataT, colsT, x)
        if self.dist is not None and self.dist[0] == "gather":
            mesh = self.dist[1]
            y = mesh.allreduce_sum(y)
            return mesh.slab(y) if self.col_slab else y
        return y

    def to_dense(self) -> np.ndarray:
        n, L = self.data.shape
        out = np.zeros((n, self.ncols))
        np.add.at(
            out,
            (np.repeat(np.arange(n), L), self.cols.cpu().numpy().ravel()),
            self.data.detach().cpu().double().numpy().ravel(),
        )
        return out


def field_slices(sizes: dict) -> dict:
    out = {}
    off = 0
    for k, n in sizes.items():
        out[k] = slice(off, off + n)
        off += n
    return out


class FieldMatrix(nn.Module):
    """Block matrix over named contiguous field segments; missing blocks are
    zero.  Blocks are keyed (row_field, col_field)."""

    def __init__(self, blocks: dict, sizes: dict):
        super().__init__()
        self.blocks = nn.ModuleDict({r + c: blk for (r, c), blk in blocks.items()})
        self.sizes = dict(sizes)
        self.slices = field_slices(self.sizes)
        self.n = sum(self.sizes.values())

    def block(self, r, c):
        return self.blocks[r + c] if (r + c) in self.blocks else None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        segs = {k: x[s] for k, s in self.slices.items()}
        outs = []
        for rf in self.sizes:
            acc = x.new_zeros(self.sizes[rf])
            for cf in self.sizes:
                blk = self.block(rf, cf)
                if blk is not None:
                    acc = acc + blk.matvec(segs[cf])
            outs.append(acc)
        return torch.cat(outs)

    forward = matvec

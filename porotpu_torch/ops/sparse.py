"""ELL storage and the per-field block operator (porotpu/ops/sparse.py).

ELL is the last-resort format of ``device_matrix`` (unbanded blocks); its
product is a plain torch gather, as porotpu computes it outside Pallas.
The transpose product is the same gather on a transposed ELL built with
the matrix on the host (``store_transpose``; ``device_matrix`` asks for
it where a solve transposes, the AMG prolongators): a scatter-add
(``index_add_``) sums in an order that changes from run to run on the
card, and made two runs of one solve differ in the last bits.  On the
card an ELL built without the layout refuses its transpose; on the CPU it
transposes on the fly.  ``ELL_PRODUCTS`` counts the products by (product,
dtype, rows, width).
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn


ELL_PRODUCTS = collections.Counter()


def _ell_arrays(A: sp.csr_matrix):
    """(data f64, cols int64) of the padded rows of a CSR matrix; a row's pad
    slots repeat its own first column with a zero value (the gather stays
    local)."""
    n = A.shape[0]
    counts = np.diff(A.indptr)
    L = max(int(counts.max()) if n else 1, 1)
    data = np.zeros((n, L), dtype=np.float64)
    cols = np.zeros((n, L), dtype=np.int64)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    data[rows, pos] = A.data
    cols[rows, pos] = A.indices
    pad = np.arange(L)[None, :] >= counts[:, None]
    return data, np.where(pad, cols[:, 0:1], cols)


def ell_transpose(data: np.ndarray, cols: np.ndarray, ncols: int):
    """(dataT f64, colsT int64): the ELL arrays of A^T for the ELL arrays of A."""
    n, L = data.shape
    A = sp.csr_matrix(
        (data.ravel(), (np.repeat(np.arange(n), L), cols.ravel())), shape=(n, ncols)
    )
    A.sum_duplicates()
    A.eliminate_zeros()
    return _ell_arrays(A.T.tocsr())


class ELL(nn.Module):
    """Padded-row (ELLPACK) sparse matrix: data (n, L), cols (n, L); with
    the transposed layout, dataT (ncols, LT) and colsT (ncols, LT) hold the
    ELL of A^T, each row's entries in increasing row order of A."""

    dist = None  # None, or ("gather", mesh): rows in slabs, columns global
    col_slab = True

    def __init__(self, data, cols, ncols, dataT=None, colsT=None):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("cols", cols)
        self.register_buffer("dataT", dataT)
        self.register_buffer("colsT", colsT)
        self.ncols = int(ncols)

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

    def _count(self, product):
        n, L = self.data.shape
        ELL_PRODUCTS[product, str(self.data.dtype).removeprefix("torch."), n, L] += 1

    def matvec(self, x):
        self._count("matvec")
        if self.dist is not None and self.dist[0] == "gather" and self.col_slab:
            x = self.dist[1].all_gather(x)
        return (self.data * x[self.cols]).sum(1)

    forward = matvec

    def rmatvec(self, x):
        """A^T x: the gather on the transposed layout, summed in a fixed
        order."""
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
        self._count("rmatvec")
        y = (dataT * x[colsT]).sum(1)
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

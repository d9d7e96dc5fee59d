"""ELL storage and the per-field block operator (porotpu/ops/sparse.py).

ELL is the last-resort format of ``device_matrix`` (unbanded blocks); its
product is a plain torch gather, as porotpu computes it outside Pallas.
``ELL_PRODUCTS`` counts those products by (product, dtype, rows, width).
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn


ELL_PRODUCTS = collections.Counter()


class ELL(nn.Module):
    """Padded-row (ELLPACK) sparse matrix: data (n, L), cols (n, L)."""

    def __init__(self, data, cols, ncols):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("cols", cols)
        self.ncols = int(ncols)

    @property
    def shape(self):
        return (self.data.shape[0], self.ncols)

    @classmethod
    def from_csr(cls, A: sp.spmatrix, dtype=torch.float32) -> "ELL":
        A = A.tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        n, m = A.shape
        counts = np.diff(A.indptr)
        L = max(int(counts.max()) if n else 1, 1)
        data = np.zeros((n, L), dtype=np.float64)
        cols = np.zeros((n, L), dtype=np.int64)
        rows = np.repeat(np.arange(n), counts)
        pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        data[rows, pos] = A.data
        cols[rows, pos] = A.indices
        # pad columns with each row's own first column (the gather stays local)
        pad = np.arange(L)[None, :] >= counts[:, None]
        cols = np.where(pad, cols[:, 0:1], cols)
        return cls(torch.as_tensor(data, dtype=dtype), torch.from_numpy(cols), m)

    def _count(self, product):
        n, L = self.data.shape
        ELL_PRODUCTS[product, str(self.data.dtype).removeprefix("torch."), n, L] += 1

    def matvec(self, x):
        self._count("matvec")
        return (self.data * x[self.cols]).sum(1)

    forward = matvec

    def rmatvec(self, x):
        self._count("rmatvec")
        out = x.new_zeros(self.ncols)
        return out.index_add_(0, self.cols.reshape(-1), (self.data * x[:, None]).reshape(-1))

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

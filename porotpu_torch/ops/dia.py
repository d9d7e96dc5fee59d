"""DIA (banded) storage and the small dense format (porotpu/ops/dia.py).

    y[i] = sum_d data[d, i] * xe[i + off_d]

Every banded product goes through ``dia_kernel``: a CUDA kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor.  Forward
products run K1 (``dia_kernel.mv``).  The transpose of a banded matrix
is banded with negated offsets, so in f32, as in porotpu, operators whose
transpose product is hot (prolongators, ``Transposed`` coupling blocks)
store the transposed layout ``dataT`` and run K1 on (dataT, -offsets).
Every other transpose runs K2 (``dia_kernel.rmv``) on A's own layout.

Rectangular cross-space blocks are handled by a column embedding
``col_emb``: the input is scattered into the row lattice (size ``ne``)
once, then the banded sweep runs unchanged.

The sharded (halo / gspmd) paths of porotpu are not ported here.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from . import dia_kernel


def _emb_tensor(col_emb):
    return None if col_emb is None else torch.tensor(
        np.asarray(col_emb), dtype=torch.int64
    )


def transpose_layout(data: torch.Tensor, offsets, ne: int) -> torch.Tensor:
    """The transposed layout dataT (nd, ne), dataT[d, i + offsets[d]] =
    data[d, i] for the rows that land inside [0, ne), zero elsewhere; built
    on data's device."""
    nd, nrows = data.shape
    dst = torch.arange(nrows, device=data.device)[None, :] + torch.as_tensor(
        offsets, dtype=torch.int64, device=data.device)[:, None]
    ok = (dst >= 0) & (dst < ne)
    d_idx = torch.arange(nd, device=data.device)[:, None].expand_as(dst)
    dataT = torch.zeros((nd, ne), dtype=data.dtype, device=data.device)
    dataT[d_idx[ok], dst[ok]] = data[ok]
    return dataT


class DIA(nn.Module):
    """Banded matrix with static diagonal offsets.

    data: (nd, nrows) buffer, data[d, i] = A[i, j] where emb(j) = i + offsets[d]
    col_emb: optional (ncols,) int64 buffer embedding columns into row space
    dataT: optional (nd, ne) transposed layout, dataT[d, i + offsets[d]] = data[d, i]
    """

    def __init__(self, data, offsets, nrows, ncols, col_emb=None, ne=None, dataT=None):
        super().__init__()
        self.offsets = tuple(int(o) for o in offsets)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        col_emb = _emb_tensor(col_emb)
        if ne is None:
            ne = self.ncols if col_emb is None else max(
                self.nrows, int(col_emb.max()) + 1
            )
        self.ne = int(ne)
        self.register_buffer("data", data)
        self.register_buffer("dataT", dataT)
        self.register_buffer("col_emb", col_emb)
        off = torch.tensor(self.offsets, dtype=torch.int32)
        self.register_buffer("offsets_dev", off)
        self.register_buffer("neg_offsets_dev", -off)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_csr(
        cls,
        A: sp.spmatrix,
        dtype=torch.float32,
        col_emb: np.ndarray | None = None,
        max_diags: int | None = None,
        store_transpose: bool = False,
    ) -> "DIA | None":
        """Convert CSR to DIA; None if the diagonal count exceeds ``max_diags``.

        Copy of porotpu/ops/dia.py:258-286: ``store_transpose`` builds
        ``dataT`` for float32 only and is skipped for other dtypes.
        """
        A = A.tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        n, m = A.shape
        coo = A.tocoo()
        ecol = coo.col if col_emb is None else col_emb[coo.col]
        off = ecol.astype(np.int64) - coo.row
        offsets = np.unique(off)
        if max_diags is not None and len(offsets) > max_diags:
            return None
        nd = max(len(offsets), 1)
        didx = np.searchsorted(offsets, off)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        data = np.zeros((nd, n), dtype=np_dtype)
        data[didx, coo.row] = coo.data
        offs = list(int(o) for o in offsets) or [0]
        data = torch.from_numpy(data)
        dataT = None
        if store_transpose and dtype == torch.float32:
            ne = m if col_emb is None else max(n, int(col_emb.max()) + 1)
            dataT = transpose_layout(data, offs, ne)
        return cls(data, tuple(offs), n, m, col_emb, dataT=dataT)

    # -- products -------------------------------------------------------

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.col_emb is not None:
            xe = x.new_zeros(self.ne)
            xe[self.col_emb] = x
        else:
            xe = x
        return dia_kernel.mv(self.data, self.offsets, self.offsets_dev, xe, self.nrows)

    forward = matvec

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """A^T x: K1 on (dataT, -offsets) when the transposed layout is
        stored, otherwise K2 on (data, offsets)."""
        if self.dataT is not None:
            y = dia_kernel.mv(
                self.dataT,
                tuple(-o for o in self.offsets),
                self.neg_offsets_dev,
                x,
                self.ne,
            )
        else:
            y = dia_kernel.rmv(self.data, self.offsets, self.offsets_dev, x, self.ne)
        if self.col_emb is not None:
            return y[self.col_emb]
        return y[: self.ncols]

    def to_dense(self) -> np.ndarray:
        ne = self.ne
        out = np.zeros((self.nrows, ne + 1 + max(max(self.offsets), 0)))
        d = self.data.detach().cpu().double().numpy()
        rows = np.arange(self.nrows)
        for k, o in enumerate(self.offsets):
            cols = rows + o
            ok = (cols >= 0) & (cols < out.shape[1])
            out[rows[ok], cols[ok]] += d[k, ok]
        out = out[:, :ne]
        if self.col_emb is not None:
            return out[:, self.col_emb.cpu().numpy()]
        return out[:, : self.ncols]


class Transposed(nn.Module):
    """Apply the transpose of a stored operator: matvec <-> rmatvec."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    @property
    def shape(self):
        s = self.inner.shape
        return (s[1], s[0])

    def matvec(self, x):
        return self.inner.rmatvec(x)

    forward = matvec

    def rmatvec(self, x):
        return self.inner.matvec(x)

    def to_dense(self):
        return self.inner.to_dense().T


class Dense(nn.Module):
    """Small dense matrix; its product is a plain torch.matmul."""

    def __init__(self, data):
        super().__init__()
        self.register_buffer("data", data)

    @classmethod
    def from_csr(cls, A: sp.spmatrix, dtype=torch.float32):
        return cls(torch.as_tensor(A.toarray(), dtype=dtype))

    @property
    def shape(self):
        return tuple(self.data.shape)

    def matvec(self, x):
        return self.data @ x

    forward = matvec

    def rmatvec(self, x):
        return x @ self.data

    def to_dense(self):
        return self.data.detach().cpu().double().numpy()


# -- format choice (copy of porotpu/ops/dia.py:708-770) -----------------------


def _dia_cost(A: sp.coo_matrix, emb, max_diags):
    """Streaming cost (stored elements) of DIA storage, or None."""
    ecol = A.col if emb is None else emb[A.col]
    offsets = np.unique(ecol.astype(np.int64) - A.row)
    if len(offsets) > max_diags:
        return None
    return len(offsets) * A.shape[0]


def device_matrix(
    A: sp.spmatrix,
    dtype=torch.float32,
    col_emb: np.ndarray | None = None,
    row_emb: np.ndarray | None = None,
    max_diags: int = 1024,
    dense_max: int = 16_000_000,
    need_rmatvec: bool = False,
):
    """Pick the storage format of a host CSR matrix by streaming cost:
    DIA, the banded transpose via ``Transposed``, small dense, or ELL."""
    from .sparse import ELL

    A = A.tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    n, m = A.shape
    coo = A.tocoo()
    if coo.nnz == 0:
        return DIA(torch.zeros((1, n), dtype=dtype), (0,), n, m, None)

    candidates = []  # (cost, order, constructor)
    c = _dia_cost(coo, col_emb, max_diags)
    if c is not None:
        candidates.append(
            (c, 0, lambda: DIA.from_csr(
                A, dtype, col_emb=col_emb, store_transpose=need_rmatvec
            ))
        )
    At = A.T.tocsr()
    ct = _dia_cost(At.tocoo(), row_emb, max_diags)
    if ct is not None:
        candidates.append(
            (ct, 1, lambda: Transposed(
                DIA.from_csr(At, dtype, col_emb=row_emb, store_transpose=True)
            ))
        )
    if n * m <= dense_max:
        candidates.append((n * m, 2, lambda: Dense.from_csr(A, dtype)))
    counts = np.diff(A.indptr)
    L = max(int(counts.max()) if n else 1, 1)
    candidates.append((50 * n * L, 3, lambda: ELL.from_csr(A, dtype)))
    candidates.sort(key=lambda t: (t[0], t[1]))
    return candidates[0][2]()

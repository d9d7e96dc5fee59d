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

On a row mesh (``parallel/sharding.py``) an operator holds the slab of
its rows and its ``dist`` tag says how a product communicates
(porotpu/ops/dia.py:326-510):

- ``None``: no mesh, or an operator every rank holds whole (AMG levels
  >= 1): the code above;
- ``("halo", mesh)``: the embedded space is the row space and the halo,
  ``hl = max(0, -min off)`` left and ``hr = max(off, 0)`` right, fits one
  slab.  The matvec receives ``hl`` entries from the left neighbour and
  ``hr`` from the right one in one exchange.  Where the mesh's exchange
  can overlap compute (``mesh.halo_split``: NCCL) it starts the exchange,
  makes the slab's K1 launch on ``x_loc`` alone (offsets unshifted: the
  interior rows ``[hl, nloc - hr)`` read only the slab) while the
  messages fly, then waits and recomputes the ``hl`` top and ``hr``
  bottom rows with two small K1 launches on the received halos
  (porotpu's ``sweep_split``).  Elsewhere (gloo), with no interior
  (``nloc <= hl + hr``) or with one rank it waits first and makes one
  K1 launch on the window
  ``[from_left | x_loc | from_right]``, offsets shifted by ``+hl``.  The
  transpose makes one K2 launch over the window of
  ``hl + nloc + hr`` columns, then sends its two overflows to the
  neighbours and adds theirs in.  Embedded blocks (``col_emb``) read a
  replicated input (an all-gathered field, or an AMG coarse vector): the
  matvec scatters the window's range of it, the transpose takes the
  window's range of its output at ``emb`` and sums it over the ranks, so
  neither exchanges halos; a block whose band is its diagonal exchanges
  nothing either (counted as ``local``);
- ``("gather", mesh)``, porotpu's ``("gspmd",)``: the slab is narrower
  than the halo or the embedded space is not the row space.  The input
  is all-gathered and K1 or K2 run on the slab with offsets shifted by
  ``rank * nloc``; a transpose sums its output over the ranks.

``col_slab`` says whether the column space (the matvec's input, the
transpose's output) is a field in slabs or replicated.  A rank's local
compute is a plain function of (slab, window, shift): ``halo_matvec_local``,
``halo_interior_local``, ``halo_fixup_local``, ``halo_rmatvec_local`` and
``halo_fold``.  A ``Transposed`` block's tag
is its inner DIA's; ``Dense`` and ELL take ``("gather", mesh)``.
"""

from __future__ import annotations

import collections

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


# Products on a row mesh by (dist kind, product, embedded): a halo block
# that is not embedded makes one exchange a direction with a halo
MESH_PRODUCTS = collections.Counter()


def halo_matvec_local(data, shift, shift_dev, window, nnz=None):
    """One rank's halo matvec: K1 on the window of its slab's input, the
    offsets shifted by the window's left halo.  ``nnz`` (here and below):
    the structural nonzeros of the data, for ``dia_kernel``'s counters."""
    return dia_kernel.mv(data, shift, shift_dev, window, data.shape[1], nnz=nnz)


def halo_interior_local(data, offsets, offsets_dev, x_loc, nnz=None):
    """The split halo matvec's first launch, made while the exchange flies:
    K1 on the slab alone, offsets unshifted.  K1 reads zeros outside the
    slab, so the rows [hl, nloc - hr) are right and the hl top and hr
    bottom rows wait for ``halo_fixup_local``."""
    return dia_kernel.mv(data, offsets, offsets_dev, x_loc, data.shape[1], nnz=nnz)


def halo_fixup_local(y, top, bottom, shift, shift_dev, x_loc, from_left, from_right,
                     nnz=(None, None)):
    """Overwrite the ``hl`` top and ``hr`` bottom rows of ``y`` (the interior
    launch's output) from the received halos: K1 on ``top`` (data's first
    hl columns) over [from_left | x_loc[:hl + hr]] and on ``bottom`` (its
    last hr columns) over [x_loc[-(hl + hr):] | from_right], the offsets
    shifted by hl.  Each takes the diagonal groups of the slab's launch,
    so every row is summed in the order of the unsplit product.  ``nnz``:
    those of ``top`` and ``bottom``."""
    nloc = y.shape[0]
    hl, hr = from_left.shape[0], from_right.shape[0]
    if hl:
        xt = torch.cat([from_left, x_loc[: hl + hr]])
        y[:hl] = dia_kernel.mv(top, shift, shift_dev, xt, hl, groups_of=nloc, nnz=nnz[0])
    if hr:
        xb = torch.cat([x_loc[nloc - hl - hr :], from_right])
        y[nloc - hr :] = dia_kernel.mv(bottom, shift, shift_dev, xb, hr, groups_of=nloc,
                                       nnz=nnz[1])
    return y


def halo_rmatvec_local(data, shift, shift_dev, x, hl, hr, nnz=None):
    """One rank's halo transpose before the fold: K2 over the window of
    ``hl + nloc + hr`` columns, the offsets shifted by ``hl``."""
    return dia_kernel.rmv(data, shift, shift_dev, x, hl + data.shape[1] + hr, nnz=nnz)


def halo_fold(acc, hl, hr, from_left, from_right):
    """The rank's slab of a halo transpose: the window's middle, plus the
    left neighbour's right overflow on its first ``hr`` entries and the
    right neighbour's left overflow on its last ``hl``."""
    nloc = acc.shape[0] - hl - hr
    y = acc[hl : hl + nloc].clone()
    if hr:
        y[:hr] += from_left
    if hl:
        y[nloc - hl :] += from_right
    return y


def _window_scatter(emb: torch.Tensor, lo: int, width: int):
    """(src, dst): the columns whose embedded slot lies in [lo, lo + width),
    and that slot in the window."""
    hit = (emb >= lo) & (emb < lo + width)
    src = torch.nonzero(hit).flatten()
    return src, emb[src] - lo


class DIA(nn.Module):
    """Banded matrix with static diagonal offsets.

    data: (nd, nrows) buffer, data[d, i] = A[i, j] where emb(j) = i + offsets[d]
    col_emb: optional (ncols,) int64 buffer embedding columns into row space
    dataT: optional (nd, ne) transposed layout, dataT[d, i + offsets[d]] = data[d, i]
    On a mesh data holds the rank's slab (nd, nloc) and nrows stays global.
    nnz: the structural nonzeros among data's values (those of dataT are
    the same), the CSR's count or else data's nonzeros when it is built;
    every product reports them to ``dia_kernel``'s counters.
    """

    nnz = None  # a DIA pickled before the count was kept reports none
    dist = None  # None, ("halo", mesh) or ("gather", mesh)
    col_slab = True  # on a mesh: the column space is a field in slabs
    split = False  # on a mesh: the halo matvec can run its interior under the exchange

    def __init__(self, data, offsets, nrows, ncols, col_emb=None, ne=None, dataT=None,
                 nnz=None):
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
        self.nnz = int(torch.count_nonzero(data)) if nnz is None else int(nnz)
        self.register_buffer("col_emb", col_emb)
        off = torch.tensor(self.offsets, dtype=torch.int32)
        self.register_buffer("offsets_dev", off)
        self.register_buffer("neg_offsets_dev", -off)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def set_dist(self, kind: str, mesh, col_slab: bool):
        """Tag a slab ``("halo", mesh)`` or ``("gather", mesh)`` and build the
        shifted offsets (and, for an embedded halo block, the window's
        scatter) of this rank."""
        nloc = self.data.shape[1]
        self.dist = (kind, mesh)
        self.col_slab = bool(col_slab)
        if kind == "halo":
            self.halo = (max(0, -min(self.offsets)), max(0, max(self.offsets)))
            shift = self.halo[0]
        else:
            shift = mesh.rank * nloc
        self.shift = tuple(o + shift for o in self.offsets)
        self.register_buffer("shift_dev", torch.tensor(self.shift, dtype=torch.int32))
        # the interior/boundary split: the slab's first hl and last hr
        # columns for the fix-ups (porotpu's sweep_split, :366-405)
        self.split = (kind == "halo" and self.col_emb is None
                      and mesh.world > 1 and nloc - sum(self.halo) > 0)
        if self.split:
            hl, hr = self.halo
            self.register_buffer("data_top", self.data[:, :hl].contiguous())
            self.register_buffer("data_bottom", self.data[:, nloc - hr :].contiguous())
            self.nnz_split = (int(torch.count_nonzero(self.data_top)),
                              int(torch.count_nonzero(self.data_bottom)))
        if kind == "halo" and self.col_emb is not None:
            hl, hr = self.halo
            src, dst = _window_scatter(self.col_emb, mesh.rank * nloc - hl, hl + nloc + hr)
            self.register_buffer("win_src", src)
            self.register_buffer("win_dst", dst)
        return self

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
        return cls(data, tuple(offs), n, m, col_emb, dataT=dataT, nnz=coo.nnz)

    # -- products -------------------------------------------------------

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.dist is not None:
            return self._mesh_matvec(x)
        if self.col_emb is not None:
            xe = x.new_zeros(self.ne)
            xe[self.col_emb] = x
        else:
            xe = x
        return dia_kernel.mv(self.data, self.offsets, self.offsets_dev, xe, self.nrows,
                             nnz=self.nnz)

    forward = matvec

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """A^T x: K1 on (dataT, -offsets) when the transposed layout is
        stored, otherwise K2 on (data, offsets)."""
        if self.dist is not None:
            return self._mesh_rmatvec(x)
        if self.dataT is not None:
            y = dia_kernel.mv(
                self.dataT,
                tuple(-o for o in self.offsets),
                self.neg_offsets_dev,
                x,
                self.ne,
                nnz=self.nnz,
            )
        else:
            y = dia_kernel.rmv(self.data, self.offsets, self.offsets_dev, x, self.ne,
                               nnz=self.nnz)
        if self.col_emb is not None:
            return y[self.col_emb]
        return y[: self.ncols]

    def _local(self):
        """A halo block whose band is its diagonal: nothing to exchange."""
        return self.dist[0] == "halo" and self.col_emb is None and not any(self.halo)

    def _mesh_matvec(self, x):
        kind, mesh = self.dist
        nloc = self.data.shape[1]
        if self._local():
            MESH_PRODUCTS["local", "matvec", False] += 1
            return halo_matvec_local(self.data, self.shift, self.shift_dev, x, self.nnz)
        MESH_PRODUCTS[kind, "matvec", self.col_emb is not None] += 1
        if kind == "halo" and self.col_emb is None:
            hl, hr = self.halo
            pending = mesh.exchange_start(x[:hr], x[nloc - hl :])
            if not (self.split and mesh.halo_split):
                from_left, from_right = pending.wait()
                return halo_matvec_local(self.data, self.shift, self.shift_dev,
                                         torch.cat([from_left, x, from_right]), self.nnz)
            y = halo_interior_local(self.data, self.offsets, self.offsets_dev, x, self.nnz)
            from_left, from_right = pending.wait()
            return halo_fixup_local(y, self.data_top, self.data_bottom, self.shift,
                                    self.shift_dev, x, from_left, from_right, self.nnz_split)
        xs = mesh.all_gather(x) if self.col_slab else x
        if kind == "halo":
            hl, hr = self.halo
            window = xs.new_zeros(hl + nloc + hr)
            window[self.win_dst] = xs[self.win_src]
            return halo_matvec_local(self.data, self.shift, self.shift_dev, window, self.nnz)
        if self.col_emb is not None:
            xe = xs.new_zeros(self.ne)
            xe[self.col_emb] = xs
        else:
            xe = xs
        return dia_kernel.mv(self.data, self.shift, self.shift_dev, xe, nloc, nnz=self.nnz)

    def _mesh_rmatvec(self, x):
        kind, mesh = self.dist
        if self._local():
            MESH_PRODUCTS["local", "rmatvec", False] += 1
            return halo_rmatvec_local(self.data, self.shift, self.shift_dev, x, 0, 0, self.nnz)
        MESH_PRODUCTS[kind, "rmatvec", self.col_emb is not None] += 1
        if kind == "halo":
            hl, hr = self.halo
            acc = halo_rmatvec_local(self.data, self.shift, self.shift_dev, x, hl, hr, self.nnz)
            if self.col_emb is None:
                nloc = self.data.shape[1]
                from_left, from_right = mesh.exchange(acc[:hl], acc[hl + nloc :])
                return halo_fold(acc, hl, hr, from_left, from_right)
            y = acc.new_zeros(self.ncols)
            y[self.win_src] = acc[self.win_dst]
        else:
            acc = dia_kernel.rmv(self.data, self.shift, self.shift_dev, x, self.ne, nnz=self.nnz)
            y = acc[self.col_emb] if self.col_emb is not None else acc[: self.ncols]
        y = mesh.allreduce_sum(y)
        return mesh.slab(y) if self.col_slab else y

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
    """Small dense matrix; its product is a plain torch.matmul.  On a mesh
    it holds its rows' slab, gathers a field input and sums its transpose
    over the ranks."""

    dist = None  # None, or ("gather", mesh) on a row mesh
    col_slab = True

    def __init__(self, data):
        super().__init__()
        self.register_buffer("data", data)

    def set_dist(self, mesh, col_slab: bool):
        self.dist = ("gather", mesh)
        self.col_slab = bool(col_slab)
        return self

    @classmethod
    def from_csr(cls, A: sp.spmatrix, dtype=torch.float32):
        return cls(torch.as_tensor(A.toarray(), dtype=dtype))

    @property
    def shape(self):
        n, m = self.data.shape
        if self.dist is not None and self.dist[0] == "gather":
            n *= self.dist[1].world
        return (n, m)

    def matvec(self, x):
        if self.dist is not None and self.dist[0] == "gather" and self.col_slab:
            x = self.dist[1].all_gather(x)
        return self.data @ x

    forward = matvec

    def rmatvec(self, x):
        y = x @ self.data
        if self.dist is not None and self.dist[0] == "gather":
            mesh = self.dist[1]
            y = mesh.allreduce_sum(y)
            return mesh.slab(y) if self.col_slab else y
        return y

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
    candidates.append(
        (50 * n * L, 3, lambda: ELL.from_csr(A, dtype, store_transpose=need_rmatvec))
    )
    candidates.sort(key=lambda t: (t[0], t[1]))
    return candidates[0][2]()

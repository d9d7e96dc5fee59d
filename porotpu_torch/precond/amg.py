"""Smoothed-aggregation AMG (porotpu/precond/amg.py).

Host setup (numpy/scipy, once per operator) is a copy of porotpu's:
lattice-box aggregation when node coordinates are given, else greedy
strength-graph aggregation over nodes; then the tentative prolongator
from the near-nullspace, Jacobi prolongator smoothing, band-wise P
truncation, Galerkin coarse operators, 128-row padding of the coarse
levels and a dense coarse inverse.  The V-cycle runs on the device:
Chebyshev smoothing and the transfers, every banded product through
``ops.dia`` (kernel K1 on CUDA).  ``device_matrix`` picks each level's
storage format as porotpu's: a greedy prolongator stays banded only
while its aggregates are lattice-near, else it stores ELL.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dia import device_matrix

# ---------------------------------------------------------------------------
# host setup: copies of porotpu/precond/amg.py (36-264, 371-574)
# ---------------------------------------------------------------------------


def _node_graph(A: sp.csr_matrix, d: int) -> sp.csr_matrix:
    """The node graph of a matrix with d dofs per node: entry (I, J) sums
    |a_ij| over the dof block (porotpu/precond/amg.py:36).  For d > 1 this
    is porotpu's native linear pass (porotpu/native/aggregation.cpp:
    collapse_node_graph): |a_ij| at (i // d, j // d), summed as scipy sums
    duplicates.  Its Q^T |A| Q fallback would sort an unsorted A's indices
    in place (``abs`` canonicalizes), and the next level's A @ P would then
    round differently from porotpu's."""
    if d == 1:
        return abs(A).tocsr()
    n = A.shape[0]
    rows = np.repeat(np.arange(n) // d, np.diff(A.indptr))
    C = sp.coo_matrix(
        (np.abs(A.data), (rows, A.indices // d)), shape=(n // d, n // d)
    ).tocsr()
    C.sum_duplicates()
    return C


def _strength(C: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength of connection, |c_ij| >= theta sqrt(c_ii c_jj),
    off the diagonal (porotpu/precond/amg.py:78)."""
    C = C.tocsr()
    diag = np.asarray(C.diagonal())
    diag[diag <= 0] = 1.0
    rows = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
    thresh = theta * np.sqrt(diag[rows] * diag[C.indices])
    keep = (np.abs(C.data) >= thresh) & (rows != C.indices)
    return sp.csr_matrix((np.ones(keep.sum()), (rows[keep], C.indices[keep])), shape=C.shape)


def _aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy standard aggregation of a strength graph: the aggregate id of
    each node (porotpu/precond/amg.py:91-131)."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    na = 0
    # pass 1: roots whose strong neighbourhood is all free
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if np.all(agg[nbrs] == -1):
            agg[i] = na
            agg[nbrs] = na
            na += 1
    # pass 2: stragglers join the first aggregated neighbour
    for i in range(n):
        if agg[i] != -1:
            continue
        anbrs = agg[indices[indptr[i] : indptr[i + 1]]]
        anbrs = anbrs[anbrs != -1]
        if anbrs.size:
            agg[i] = anbrs[0]
    # pass 3: isolated nodes become aggregates of their own
    for i in range(n):
        if agg[i] == -1:
            agg[i] = na
            na += 1
    return agg


def _aggregate_boxes(coords: np.ndarray, h_box: float) -> np.ndarray:
    """Nodes sharing a quantized coordinate box form one aggregate; ids
    follow (z, y, x)-lex box order (porotpu/precond/amg.py:134)."""
    key = np.floor((coords - coords.min(axis=0)) / max(h_box, 1e-300))
    key = key.astype(np.int64)[:, ::-1]
    _, agg = np.unique(key, axis=0, return_inverse=True)
    return agg


def _node_spacing(coords: np.ndarray) -> float:
    """Typical nearest-neighbor spacing of lex-ordered lattice nodes
    (porotpu/precond/amg.py:150)."""
    if coords.shape[0] < 2:
        return 1.0
    d = np.linalg.norm(np.diff(coords, axis=0), axis=1)
    d = d[d > 0]
    return float(np.median(d)) if d.size else 1.0


def _tentative_prolongator(dof_agg: np.ndarray, B: np.ndarray):
    """T (n_dofs x n_coarse) with per-aggregate orthonormal columns, the
    coarse near-nullspace, the coarse column embedding and the coarse
    dof -> aggregate map (porotpu/precond/amg.py:159)."""
    n = dof_agg.size
    k = B.shape[1]
    na = int(dof_agg.max()) + 1
    order = np.argsort(dof_agg, kind="stable")
    sizes = np.bincount(dof_agg, minlength=na)
    maxs = int(sizes.max())
    Bpad = np.zeros((na, maxs, k))
    pos = np.arange(n) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    Bpad[dof_agg[order], pos, :] = B[order, :]
    U, S, Vh = np.linalg.svd(Bpad, full_matrices=False)
    # deterministic signs: largest-|.| entry of each U column positive
    amax = np.argmax(np.abs(U), axis=1)
    sgn = np.sign(np.take_along_axis(U, amax[:, None, :], axis=1))[:, 0, :]
    sgn[sgn == 0] = 1.0
    U = U * sgn[:, None, :]
    Vh = Vh * sgn[:, :, None]
    # rank detection: keep directions with non-negligible singular value
    smax = S[:, :1]
    keep = S > np.maximum(smax, 1e-30) * 1e-8
    ncols = keep.sum(axis=1)
    n_coarse = int(ncols.sum())
    col_of = np.full((na, k), -1, dtype=np.int64)
    col_of[keep] = np.arange(n_coarse)
    data = U[dof_agg[order], pos, :]
    cols = col_of[dof_agg[order], :]
    rows = np.repeat(order, k)
    sel = cols.ravel() >= 0
    T = sp.csr_matrix(
        (data.ravel()[sel], (rows[sel], cols.ravel()[sel])),
        shape=(n, max(n_coarse, 1)),
    )
    Bc = np.zeros((max(n_coarse, 1), k))
    Bc[col_of[keep], :] = (S[:, :, None] * Vh)[keep]
    starts = np.cumsum(sizes) - sizes
    aa, _ = np.nonzero(keep)
    ranks = (np.cumsum(keep, axis=1) - 1)[keep]
    emb = np.zeros(max(n_coarse, 1), dtype=np.int64)
    emb[col_of[keep]] = order[starts[aa] + ranks]
    node_of = np.zeros(max(n_coarse, 1), dtype=np.int64)
    node_of[col_of[keep]] = aa
    return T, Bc, emb, node_of


def _drop_weak_p_diagonals(P: sp.csr_matrix, emb: np.ndarray, tol: float):
    """Drop whole bands of P whose max |entry| < tol * max |P|
    (porotpu/precond/amg.py:228)."""
    coo = P.tocoo()
    off = emb[coo.col].astype(np.int64) - coo.row
    uniq, inv = np.unique(off, return_inverse=True)
    dmax = np.zeros(uniq.size)
    np.maximum.at(dmax, inv, np.abs(coo.data))
    keep_diag = dmax >= tol * dmax.max()
    keep = keep_diag[inv]
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=P.shape
    )


def _power_lmax(A: sp.csr_matrix, dinv: np.ndarray, iters=15, seed=0) -> float:
    """lambda_max of D^-1 A by power iteration (porotpu/precond/amg.py:253)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Elasticity near-nullspace, translations + rotations
    (porotpu/precond/amg.py:547)."""
    nn_, dim = coords.shape
    if dim == 2:
        B = np.zeros((nn_ * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -coords[:, 1]
        B[1::2, 2] = coords[:, 0]
        return B
    B = np.zeros((nn_ * 3, 6))
    for c in range(3):
        B[c::3, c] = 1.0
    B[1::3, 3] = -coords[:, 2]
    B[2::3, 3] = coords[:, 1]
    B[0::3, 4] = coords[:, 2]
    B[2::3, 4] = -coords[:, 0]
    B[0::3, 5] = -coords[:, 1]
    B[1::3, 5] = coords[:, 0]
    return B


# ---------------------------------------------------------------------------
# device V-cycle
# ---------------------------------------------------------------------------


class AMGLevel(nn.Module):
    def __init__(self, A, P, dinv, lmax):
        super().__init__()
        self.A = A
        self.P = P  # prolongator; restriction is P^T (K1 on dataT in f32, else K2)
        self.register_buffer("dinv", dinv)
        self.lmax = float(lmax)


class AMG(nn.Module):
    """V-cycle preconditioner: x = AMG(b).  The coarsest level is a dense
    matvec with the explicit inverse (computed in f64 on the host).  On a
    row mesh (``parallel.shard_amg``) level 0 holds the rank's slabs and
    every rank runs the replicated levels below it whole; a hierarchy
    with no level gathers its field for the replicated inverse."""

    mesh = None

    def __init__(self, levels, coarse_inv, presmooth=1, postsmooth=1, cheb_lower=4.0):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.presmooth = presmooth
        self.postsmooth = postsmooth
        self.cheb_lower = cheb_lower

    def _smooth(self, lvl: AMGLevel, b, x, iters, x_is_zero=False):
        """Chebyshev over [lmax/cheb_lower, 1.1 lmax] of D^-1 A."""
        lmin = lvl.lmax / self.cheb_lower
        lmax = 1.1 * lvl.lmax
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma1 = theta / delta
        # presmoothing starts from x=0: r = b exactly, skip the matvec
        r = b if x_is_zero else b - lvl.A.matvec(x)
        d = (lvl.dinv * r) / theta
        rho = 1.0 / sigma1
        for _ in range(iters):
            x = x + d
            r = r - lvl.A.matvec(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (lvl.dinv * r)
            rho = rho_new
        return x + d

    def _cycle(self, li, b):
        if li == len(self.levels):
            return self.coarse_inv @ b
        lvl = self.levels[li]
        x = self._smooth(lvl, b, torch.zeros_like(b), self.presmooth, x_is_zero=True)
        r = b - lvl.A.matvec(x)
        bc = lvl.P.rmatvec(r)  # restriction = P^T r
        # coarse levels are row-padded to 128 (identity pad rows): pad the
        # coarse vector on the way down, truncate on the way up
        nc = lvl.P.shape[1]
        nxt = (
            self.levels[li + 1].A.shape[0]
            if li + 1 < len(self.levels)
            else self.coarse_inv.shape[0]
        )
        if nxt > nc:
            bc = F.pad(bc, (0, nxt - nc))
        xc = self._cycle(li + 1, bc)
        x = x + lvl.P.matvec(xc[:nc])
        return self._smooth(lvl, b, x, self.postsmooth)

    def forward(self, b):
        if self.mesh is not None and not self.levels:
            return self.mesh.slab(self.coarse_inv @ self.mesh.all_gather(b))
        return self._cycle(0, b)


def amg_setup(
    A: sp.csr_matrix,
    dofs_per_node: int = 1,
    B: np.ndarray | None = None,
    theta: float = 0.08,
    max_levels: int = 10,
    coarse_size: int = 2000,
    presmooth: int = 1,
    postsmooth: int = 1,
    coords: np.ndarray | None = None,
    h0: float | None = None,
    box_factor: float | None = None,
    smooth_degree: int = 1,
    cheb_lower: float = 4.0,
    p_drop_tol: float = 0.0,
    dtype=torch.float32,
) -> AMG:
    """Build a smoothed-aggregation hierarchy on the host (copy of
    porotpu/precond/amg.py:371-544).  With ``coords`` (n_nodes, dim) the
    aggregates are lattice boxes, so every level stays banded; without,
    greedy aggregation of the strength graph at ``theta``."""
    A = A.tocsr()
    n = A.shape[0]
    d = dofs_per_node
    if B is None:
        B = np.zeros((n, d))
        for c in range(d):
            B[c::d, c] = 1.0

    levels = []
    max_dense = max(coarse_size * 4, 6000)
    use_boxes = coords is not None
    if use_boxes:
        coords = np.asarray(coords, dtype=np.float64)
        if box_factor is None:
            box_factor = 2.0 if coords.shape[1] == 2 else 3.0
        node_of_dof = np.repeat(np.arange(coords.shape[0]), d)
        if node_of_dof.size != A.shape[0]:
            raise ValueError("coords size does not match A / dofs_per_node")
        h_node = _node_spacing(coords) if h0 is None else float(h0)

    while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
        if use_boxes:
            agg = None
            # grow the box until it actually coarsens
            for grow in range(4):
                cand = _aggregate_boxes(coords, box_factor * h_node * 2**grow)
                if int(cand.max()) + 1 <= 0.7 * coords.shape[0]:
                    agg = cand
                    h_node = box_factor * h_node * 2**grow
                    break
            if agg is None:
                break
            dof_agg = agg[node_of_dof]
        else:
            # rank-revealing column drops can leave a coarse size that is no
            # multiple of the block size: collapse per dof
            if A.shape[0] % d != 0:
                d = 1
            C = _node_graph(A, d)
            agg = _aggregate(_strength(C, theta))
            # stall guard (porotpu/precond/amg.py:442-456): a near-empty
            # strength graph (a mass-dominated block) gives singleton
            # aggregates; solve this level directly, or above the dense cap
            # retry once at theta / 4
            stalled = lambda a: (  # noqa: E731
                (int(a.max()) + 1) * B.shape[1] >= A.shape[0]
                or int(a.max()) + 1 > 0.7 * C.shape[0]
            )
            if stalled(agg):
                if A.shape[0] <= max_dense:
                    break
                agg = _aggregate(_strength(C, theta / 4.0))
                if stalled(agg):
                    break
            dof_agg = np.repeat(agg, d)
        T, Bc, emb, node_of_coarse = _tentative_prolongator(dof_agg, B)
        if T.shape[1] >= A.shape[0]:
            break
        diag = np.asarray(A.diagonal())
        diag[diag == 0] = 1.0
        dinv = 1.0 / diag
        lmax = _power_lmax(A, dinv)
        Dinv = sp.diags(dinv)
        P = T
        for _ in range(max(smooth_degree, 0)):
            P = (P - (4.0 / (3.0 * lmax)) * (Dinv @ (A @ P))).tocsr()
        if p_drop_tol > 0.0:
            P = _drop_weak_p_diagonals(P, emb, p_drop_tol)
        Ac = (P.T.tocsr() @ (A @ P)).tocsr()
        # row-pad the coarse levels (li >= 1) to 128: unit diagonal on the
        # pad rows of A, zero pad rows of P, dinv = 1 — fully decoupled
        rowpad = (-A.shape[0]) % 128 if levels else 0
        A_dev = sp.block_diag(
            [A, sp.identity(rowpad, format="csr")], format="csr"
        ) if rowpad else A
        P_dev = sp.vstack(
            [P, sp.csr_matrix((rowpad, P.shape[1]))], format="csr"
        ) if rowpad else P
        dinv_dev = np.concatenate([dinv, np.ones(rowpad)]) if rowpad else dinv
        levels.append(
            AMGLevel(
                device_matrix(A_dev, dtype),
                device_matrix(P_dev, dtype, col_emb=emb, need_rmatvec=True),
                torch.as_tensor(dinv_dev, dtype=dtype),
                lmax,
            )
        )
        A = Ac
        B = Bc
        d = B.shape[1]
        if use_boxes:
            # coarse node coords = aggregate centroids
            na = int(agg.max()) + 1
            cnt = np.bincount(agg, minlength=na).astype(np.float64)
            coords = np.stack(
                [np.bincount(agg, weights=coords[:, j], minlength=na)
                 for j in range(coords.shape[1])],
                axis=1,
            ) / cnt[:, None]
            node_of_dof = node_of_coarse

    # coarsest: dense inverse, pseudo-inverse when (near) singular
    Ad = np.asarray(A.todense(), dtype=np.float64)
    try:
        Ainv = sla.inv(Ad)
        if not np.all(np.isfinite(Ainv)):
            raise np.linalg.LinAlgError("non-finite inverse")
        scale = np.abs(Ad).max() or 1.0
        if np.abs(Ainv).max() * scale > 1e14:
            raise np.linalg.LinAlgError("ill-conditioned coarse matrix")
    except np.linalg.LinAlgError:
        Ainv = np.linalg.pinv(Ad, rcond=1e-12)
    return AMG(
        levels,
        torch.as_tensor(Ainv, dtype=dtype),
        presmooth,
        postsmooth,
        cheb_lower,
    )

"""Anderson acceleration of fixed-point iterations (porotpu/solvers/anderson.py).

Anderson type II with aligned increment pairs:
  f_k = g(x_k) - x_k
  pairs (dx_j, df_j) = (x_{j+1} - x_j, f_{j+1} - f_j), window ``order``
  alpha = argmin || f_k + sum_j alpha_j df_j ||
  x_{k+1} = x_k + f_k + sum_j alpha_j (dx_j + df_j)
The least squares go through porotpu's Gram normal equations: G = F F^T
and c = F f_k on the device, then the (order x order) system, masked to
the live pairs and ridged by 1e-12 trace/order, solved on the host in
numpy.  A pair whose ||df|| < 1e-12 is not pushed (the stagnation guard,
lib/AndersonAcceleration.py:45-47).

The rings X and F keep porotpu's layout, newest pair at index -1.  Whether
a pair is pushed depends on ||df|| on the device, so a step stages the
rolled rings with the candidate pair, computes ||df||, the Gram matrix of
the staged ring (one row more than the window: it holds both the kept
and the pushed window) and c, reads the three back in one host sync, and
keeps the staged rings only if the pair was pushed.  One sync a step,
none on the first; the mixed or the plain output is then chosen on the
host, so each is exactly its branch's value.  On a row mesh the three
are summed over the ranks in that sync's one all-reduce (``gram_read``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AndersonState:
    X: torch.Tensor  # (order, n) dx history ring, newest at index -1
    F: torch.Tensor  # (order, n) df history ring, newest at index -1
    xk: torch.Tensor  # (n,) current iterate
    fk: torch.Tensor  # (n,) current residual g(xk) - xk
    prev_dx: torch.Tensor  # (n,) x_k - x_{k-1}
    k: int  # step counter
    nhist: int  # number of valid pairs


def masked_gram_alpha(G, c, nhist, reg=0.0):
    """porotpu's Gram solve on the host: alpha over the last ``nhist`` of
    the m rows whose Gram matrix is G (m x m) and right-hand side c = F f;
    the other rows get alpha = 0 (porotpu/solvers/anderson.py:67-85)."""
    m = G.shape[0]
    live = np.arange(m) >= (m - nhist)
    eye = np.eye(m, dtype=G.dtype)
    Gm = np.where(live[:, None] & live[None, :], G, eye)
    tr = np.abs(np.trace(Gm)) / m
    Gm = Gm + (reg + 1e-12) * tr * eye
    cm = np.where(live, c, 0.0)
    alpha = np.linalg.solve(Gm, -cm)
    return np.where(live, alpha, 0.0)


def gram_read(v, F=None, fk=None, mesh=None) -> np.ndarray:
    """[||v||, (F F^T).ravel(), F fk] on the host in one read (without F:
    [||v||]; without v: no norm).  On a row mesh (the vectors hold the
    rank's slabs) the local squared norm, Gram matrix and F fk are summed
    over the ranks in one all-reduce, and the norm's square root is taken
    after the sum."""
    parts = [] if F is None else [(F @ F.T).reshape(-1), F @ fk]
    if mesh is None:
        if v is not None:
            parts.insert(0, torch.linalg.norm(v)[None])
        return torch.cat(parts).cpu().numpy()
    if v is not None:
        parts.insert(0, torch.dot(v, v)[None])
    host = mesh.allreduce_sum(torch.cat(parts)).cpu().numpy()
    if v is not None:
        host[0] = np.sqrt(host[0])
    return host


def gram_ls_alpha(F, fk, nhist, reg=0.0, mesh=None):
    """alpha = argmin ||fk + F^T alpha|| over the last ``nhist`` rows of F
    (porotpu's function on tensors): G and c on F's device (on a mesh
    summed over the ranks), the solve on the host, alpha back on F's
    device."""
    m = F.shape[0]
    host = gram_read(None, F, fk, mesh)
    G, c = host[: m * m].reshape(m, m), host[m * m :]
    alpha = masked_gram_alpha(G, c, int(nhist), reg)
    return torch.from_numpy(alpha).to(F.device)


def alpha_to(alpha: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host alpha onto the device of ``like`` without a stream sync."""
    return torch.from_numpy(alpha).to(like.device, non_blocking=True)


class AndersonAccelerator:
    """Anderson mixing of a fixed-point output sequence.

    Usage: st = acc.init(n); st, x = acc.step(st, g(x)) per iteration.
    With order == 0 this is a pass-through (x = g(x)).
    """

    def __init__(self, order: int, reg: float = 0.0, mesh=None):
        self.order = max(int(order), 0)
        self.reg = reg
        self.mesh = mesh  # a row mesh: the state holds the rank's slabs

    def init(self, n: int, dtype=torch.float32, device="cpu") -> AndersonState:
        m = max(self.order, 1)
        z = torch.zeros((m, n), dtype=dtype, device=device)
        v = torch.zeros((n,), dtype=dtype, device=device)
        return AndersonState(z, z, v, v, v, 0, 0)

    def step(self, state: AndersonState, gk: torch.Tensor):
        fk = gk - state.xk
        if self.order == 0:
            return AndersonState(
                state.X, state.F, gk, fk, gk - state.xk, state.k + 1, state.nhist
            ), gk
        X2, F2, nh2 = state.X, state.F, state.nhist
        G = c = None
        if state.k > 0:
            df = fk - state.fk
            # staged rings: row 0 the pair a push drops, rows 1: the pushed window
            Xs = torch.cat([X2, state.prev_dx[None]])
            Fs = torch.cat([F2, df[None]])
            m = Fs.shape[0] - 1
            host = gram_read(df, Fs, fk, self.mesh)
            Gs = host[1 : 1 + (m + 1) ** 2].reshape(m + 1, m + 1)
            cs = host[1 + (m + 1) ** 2 :]
            if host[0] >= 1e-12:
                X2, F2, nh2 = Xs[1:], Fs[1:], min(state.nhist + 1, self.order)
                G, c = Gs[1:, 1:], cs[1:]
            else:
                G, c = Gs[:m, :m], cs[:m]
        if nh2 > 0:
            alpha = alpha_to(masked_gram_alpha(G, c, nh2, self.reg), gk)
            xnew = state.xk + fk + alpha @ (X2 + F2)
        else:
            xnew = gk
        return AndersonState(X2, F2, xnew, fk, xnew - state.xk, state.k + 1, nh2), xnew

"""Alternating Anderson-Richardson (AAR) linear solver (porotpu/solvers/aar.py).

Preconditioned Richardson steps ``x += omega f`` on every iteration
except each p-th, which takes the Anderson step
``x + beta f + alpha (X + beta F)`` over the increment history
(lib/AAR.py:94-111).  The residual is preconditioned, f = M(b - A x)
(lib/AAR.py:133-137); the run stops once ||f|| <= atol or ||f|| /
error0 <= rtol, error0 the unpreconditioned ||b - A x0||
(lib/AAR.py:56-58, 67-73, 117-118).  The history pairs are aligned and
solved through porotpu's Gram normal equations (``anderson.py``).

Whether a step mixes depends only on the iteration, p and the history
count, which the host knows (a pair is pushed on every step but the
first), so the loop reads back one value an iteration: ||f||, with the
Gram matrix and F f on the mixing steps, for the stop test, the ``tiny``
guard and the host's Gram solve.  ``pc_accel_order`` Anderson-mixes the
PC output as well (``AndersonAccelerator``: one more sync a step).

With ``mesh`` (a row mesh: b, x and the history rings hold the rank's
slabs) that read is one all-reduce of the local squared ||f||, Gram
matrix and F f (``anderson.gram_read``); error0 is the norm over the
ranks, and the Gram solve runs on every rank alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .anderson import AndersonAccelerator, alpha_to, gram_read, masked_gram_alpha
from .gmres import _np_dtype
from .result import SolveResult


def aar(
    A,
    b,
    M=None,
    x0=None,
    order: int = 10,
    p: int = 5,
    omega: float = 1.0,
    beta: float = 1.0,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    maxiter: int = 1000,
    pc_accel_order: int = 0,
    divtol: float = 1e20,
    monitor: bool = False,
    mesh=None,
):
    """Solve A x = b with the preconditioned AAR method.

    Parameters mirror the reference dict keys "AAR order"/"AAR p"/
    "AAR omega"/"AAR beta" (footing.py:80-83).  ``monitor`` prints each
    iteration's step type ``[R]``/``[A]`` and ||f|| (reference
    lib/AAR.py:121-123) in porotpu's format.
    """
    n = b.shape[0]
    dt = _np_dtype(b.dtype)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    m = max(order, 1)
    acc = AndersonAccelerator(pc_accel_order, mesh=mesh) if pc_accel_order > 0 else None
    ast = acc.init(n, b.dtype, b.device) if acc else None

    f_unprec = b - A(x0)
    norm = torch.linalg.norm if mesh is None else mesh.norm
    error0 = dt.type(trace.host_read(norm(f_unprec)))
    error0 = error0 if error0 > 0 else dt.type(1.0)
    # the first pair's f is preconditioned (lib/AAR.py:133-137); error0
    # stays unpreconditioned (lib/AAR.py:56-58)
    fk_old = M(f_unprec)
    X = F = b.new_zeros((m, n))
    prev_dx = torch.zeros_like(b)
    history = np.full((maxiter + 1,), np.nan, dtype=np.float32)
    history[0] = error0
    atol_t, rtol_t, divtol_t = dt.type(atol), dt.type(rtol), dt.type(divtol)
    xk, nh, it = x0, 0, 0
    err_abs, err_rel = error0, dt.type(1.0)
    while err_abs > atol_t and err_rel > rtol_t and err_abs <= divtol_t and it < maxiter:
        g = M(b - A(xk))
        if acc is not None:
            ast, g = acc.step(ast, g)
        fk = g
        if it > 0 and order > 0:
            X = torch.cat([X[1:], prev_dx[None]])
            F = torch.cat([F[1:], (fk - fk_old)[None]])
            nh = min(nh + 1, order)
        is_accel = order > 0 and (it + 1) % p == 0 and nh > 0
        host = gram_read(fk, F, fk, mesh) if is_accel else gram_read(fk, mesh=mesh)
        fnorm_h = host[0]
        if fnorm_h < dt.type(1e-14):  # tiny: keep x
            x2 = xk
        elif is_accel:
            G, c = host[1 : 1 + m * m].reshape(m, m), host[1 + m * m :]
            alpha = alpha_to(masked_gram_alpha(G, c, nh), b)
            x2 = xk + beta * fk + alpha @ (X + beta * F)
        else:
            x2 = xk + omega * fk
        if monitor:
            print("---- [AAR] it {}  [{}] res = {:.6e}".format(
                it, "A" if is_accel else "R", fnorm_h), flush=True)
        err_abs, err_rel = fnorm_h, fnorm_h / error0
        history[it + 1] = fnorm_h
        prev_dx, fk_old, xk = x2 - xk, fk, x2
        it += 1
    converged = bool(err_abs <= atol_t or err_rel <= rtol_t)
    return SolveResult(xk, it, float(err_abs), converged, history, bool(err_abs > divtol_t))

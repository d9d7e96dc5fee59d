"""GMRES and flexible GMRES with right preconditioning (porotpu/solvers/gmres.py).

The Krylov basis V (m+1, n) and, for ``fgmres``, the preconditioned
directions Z (m, n) live on the device; ``gmres`` keeps no Z and
reconstructs x = x0 + M(V y) at the end of each cycle.
Orthogonalization is CGS2 (two classical Gram-Schmidt passes as
torch.matmul).  The small Hessenberg problem — the Givens
recurrence, the masked triangular solve and the residual estimate — runs
on the host in the solve's dtype: its column arrives with the one host
sync each iteration makes for the convergence check.  Every read back
and every copy of host coefficients to the device goes through
``utils.trace`` (``host_read``, ``host_copy``), which counts them.  JAX's
``while_loop`` becomes a Python loop.

Convergence is on the unpreconditioned residual 2-norm or, with
``fieldwise=``, on the field-wise infinity-norm test of the TRUE
residual, reconstructed lazily once the 2-norm bound admits convergence
(porotpu/solvers/gmres.py:139-168).

With ``mesh`` (a row mesh: b, x and the basis hold the rank's slabs)
each norm is one all-reduce and each CGS2 pass one all-reduce of the
local ``Vk @ w``; the Hessenberg problem is replicated on every rank, as
is the Anderson step's Gram solve (one all-reduce a step).

``pc_accel_order`` Anderson-mixes the PC output of every iteration
(the reference's "inner accel order", lib/Preconditioner.py:248-249)
through one accelerator state that lives for the whole call and is
carried across restarts; ``gmres``'s final apply M(V y) goes through it
too (porotpu/solvers/gmres.py:186-190).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..utils import trace
from .anderson import AndersonAccelerator
from .convergence import FieldwiseTest
from .result import SolveResult


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _triangular_coeffs(H, g, kk, m):
    """Solve the leading kk x kk upper-triangular system; zeros beyond kk."""
    y = np.zeros(m, dtype=H.dtype)
    if kk > 0:
        y[:kk] = sla.solve_triangular(H[:kk, :kk], g[:kk], lower=False)
    return y


def _fieldwise_check(fw: FieldwiseTest, r, atol, rtol):
    """(converged, error_abs) of the field-wise test on residual r: one sync."""
    ea, er = fw.errors(r)
    done = (ea < atol) | (er < rtol)
    ea_h, done_h = trace.host_read(torch.stack([ea.double(), done.double()]))
    return bool(done_h), ea_h


def _gmres(A, b, x0, M, restart, rtol, atol, maxiter, flexible, fieldwise, divtol,
           pc_accel_order, mesh=None):
    norm = torch.linalg.norm if mesh is None else mesh.norm
    reduce = (lambda t: t) if mesh is None else mesh.allreduce_sum  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    m = min(maxiter if restart is None else restart, maxiter)
    n = b.shape[0]
    n_glob = n if mesh is None else n * mesh.world  # every rank holds equal slabs
    dt = _np_dtype(b.dtype)
    bnorm = dt.type(trace.host_read(norm(b)))
    tol = np.maximum(dt.type(atol), dt.type(rtol) * bnorm)
    history = np.full((maxiter + 1,), np.nan, dtype=np.float32)
    if fieldwise is not None:
        # ||r||_inf >= ||r||_2 / sqrt(n): the field-wise test cannot pass
        # while |g[k+1]| >= sqrt(n) * fw_tol, so skip the reconstruction
        b0max = dt.type(trace.host_read(torch.max(fieldwise.b0_norms)))
        fw_tol = np.maximum(dt.type(atol), dt.type(rtol) * b0max)
        fw_tol = fw_tol * np.sqrt(dt.type(n_glob))
    acc = AndersonAccelerator(pc_accel_order, mesh=mesh) if pc_accel_order > 0 else None
    ast = acc.init(n, b.dtype, b.device) if acc else None

    def cycle(x0c, it0):
        nonlocal ast
        r0 = b - A(x0c)
        beta_t = norm(r0)
        if fieldwise is not None:
            done, res = _fieldwise_check(fieldwise, r0, atol, rtol)
            beta = dt.type(trace.host_read(beta_t))
        else:
            beta = dt.type(trace.host_read(beta_t))
            done, res = bool(beta <= tol), float(beta)
        div = res > divtol
        history[it0] = res
        V = b.new_zeros((m + 1, n))
        V[0] = r0 / beta_t if beta > 0 else r0
        Z = b.new_zeros((m, n)) if flexible else None
        H = np.zeros((m + 1, m), dtype=dt)  # rotated (upper triangular R)
        Ho = np.zeros((m + 1, m), dtype=dt) if fieldwise is not None else None
        cs = np.zeros((m,), dtype=dt)
        sn = np.zeros((m,), dtype=dt)
        g = np.zeros((m + 1,), dtype=dt)
        g[0] = beta

        k = 0
        while not done and not div and k < m and it0 + k < maxiter:
            z = M(V[k])
            if acc is not None:
                ast, z = acc.step(ast, z)
            w = A(z)
            if flexible:
                Z[k] = z
            Vk = V[: k + 1]
            h1 = reduce(Vk @ w)
            w = w - h1 @ Vk
            h2 = reduce(Vk @ w)
            w = w - h2 @ Vk
            hk1_t = norm(w)
            col = np.zeros((m + 1,), dtype=dt)
            col[: k + 2] = trace.host_read(torch.cat([h1 + h2, hk1_t[None]]), numpy=True)
            hk1 = col[k + 1]
            V[k + 1] = w / hk1_t if hk1 > 0 else w
            if Ho is not None:
                Ho[:, k] = col

            # apply the previous Givens rotations 0..k-1, then make the new one
            for j in range(k):
                t1 = cs[j] * col[j] + sn[j] * col[j + 1]
                t2 = -sn[j] * col[j] + cs[j] * col[j + 1]
                col[j], col[j + 1] = t1, t2
            denom = np.sqrt(col[k] ** 2 + col[k + 1] ** 2)
            if denom > 0:
                ck, sk = col[k] / denom, col[k + 1] / denom
            else:
                ck, sk = dt.type(1.0), dt.type(0.0)
            cs[k], sn[k] = ck, sk
            col[k], col[k + 1] = denom, 0.0
            H[:, k] = col
            g[k + 1] = -sk * g[k]
            g[k] = ck * g[k]
            res2 = abs(g[k + 1])

            if fieldwise is not None:
                if res2 < fw_tol:
                    y = _triangular_coeffs(H, g, k + 1, m)
                    zeta = np.zeros((m + 1,), dtype=dt)
                    zeta[0] = beta
                    zeta = zeta - Ho[:, :m] @ y
                    zt = trace.host_copy(torch.from_numpy(zeta[: k + 2]), b.device)
                    done, res = _fieldwise_check(
                        fieldwise, zt @ V[: k + 2], atol, rtol
                    )
                else:
                    done, res = False, float(res2)
            else:
                done, res = bool(res2 <= tol), float(res2)
            div = res > divtol
            history[it0 + k + 1] = res
            k += 1

        if k == 0:
            return x0c, it0, res, done, div
        y = trace.host_copy(torch.from_numpy(_triangular_coeffs(H, g, k, m)[:k]), b.device)
        if flexible:
            x = x0c + y @ Z[:k]
        else:
            dx = M(y @ V[:k])
            if acc is not None:
                # the final apply goes through the same accelerated PC
                # (porotpu/solvers/gmres.py:186-190)
                ast, dx = acc.step(ast, dx)
            x = x0c + dx
        return x, it0 + k, res, done, div

    r_init = b - A(x0)
    if fieldwise is not None:
        done, res = _fieldwise_check(fieldwise, r_init, atol, rtol)
    else:
        res = float(trace.host_read(norm(r_init)))
        done = bool(dt.type(res) <= tol)
    div = res > divtol
    x, it = x0, 0
    while not done and not div and it < maxiter:
        x, it, res, done, div = cycle(x, it)
    return SolveResult(x, it, res, done, history, div)


def fgmres(
    A,
    b,
    x0=None,
    M=None,
    restart=None,
    rtol=1e-6,
    atol=0.0,
    maxiter=100,
    fieldwise: FieldwiseTest | None = None,
    divtol=1e20,
    pc_accel_order: int = 0,
    mesh=None,
):
    """Flexible GMRES, right-preconditioned (stores the Z directions).

    ``divtol``: exit with result.diverged=True once the residual exceeds it
    (reference lib/Solver.py:46-48, PETSc default 1e20).
    ``pc_accel_order``: Anderson-accelerate the PC output every iteration.
    The mixed direction lies in the span of the stored ones plus the new
    one, so the residual trace is the same as without it.
    """
    return _gmres(A, b, x0, M, restart, rtol, atol, maxiter, True, fieldwise, divtol,
                  pc_accel_order, mesh)


def gmres(
    A,
    b,
    x0=None,
    M=None,
    restart=None,
    rtol=1e-6,
    atol=0.0,
    maxiter=100,
    fieldwise: FieldwiseTest | None = None,
    divtol=1e20,
    pc_accel_order: int = 0,
    mesh=None,
):
    """Right-preconditioned GMRES for a constant M: x = x0 + M(V y) per cycle.

    With ``pc_accel_order`` the PC is no longer constant and the
    reconstruction no longer matches the directions that built H: the
    returned x is wrong, as the reference's non-flexible gmres returns it
    (swelling.py:75 warns of it; porotpu pins it in
    tests/test_ops_solvers.py::test_gmres_pc_accel_order).
    """
    return _gmres(A, b, x0, M, restart, rtol, atol, maxiter, False, fieldwise, divtol,
                  pc_accel_order, mesh)

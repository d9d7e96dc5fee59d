"""Preconditioned conjugate gradients (porotpu/solvers/cg.py).

``cg``: the outer, tolerance-based solve (``solid.py``'s, and the
``solver type`` cg of the 3-field problem).  Its stop test is porotpu's:
the unpreconditioned residual 2-norm against max(atol, rtol ||b||), or
with ``fieldwise=`` the field-wise test ``ea < atol or er < rtol``; a
residual above ``divtol`` ends the run as diverged.  The test is computed
on the device and read back once an iteration, the only host sync of
the loop (and one before it, for the first residual).

``cg_fixed``: the inner solves of the ``cg`` and ``cg+amg`` kinds, a
static count of CG steps and no convergence test, so the loop never
reads a value back from the device.

The zero guards on p.Ap and r.z are ``torch.where``s on device scalars,
as porotpu's ``jnp.where``s.  With ``mesh`` (a row mesh, vectors in
slabs) each dot product and norm is one all-reduce over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .convergence import FieldwiseTest
from .result import SolveResult


def cg(
    A,
    b,
    x0=None,
    M=None,
    rtol=1e-6,
    atol=0.0,
    maxiter=100,
    fieldwise: FieldwiseTest | None = None,
    divtol=1e20,
    mesh=None,
):
    """Solve A x = b with preconditioned CG.

    A, M: callables tensor -> tensor.  Converged when ||r||_2 <=
    max(atol, rtol ||b||), or with ``fieldwise`` when error_abs < atol or
    error_rel < rtol (reference lib/Solver.py:8-51); diverged when the
    residual exceeds ``divtol`` (reference lib/Solver.py:46-48).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    dot = torch.dot if mesh is None else mesh.dot
    norm = torch.linalg.norm if mesh is None else mesh.norm
    one = torch.ones((), dtype=b.dtype, device=b.device)
    tol2 = torch.clamp_min(rtol * norm(b), atol)

    def res_ok(r):
        """(converged, residual) of r, as one host read."""
        if fieldwise is not None:
            ea, er = fieldwise.errors(r)
            done, rn = (ea < atol) | (er < rtol), torch.clamp_min(ea, 0.0)
        else:
            rn = norm(r)
            done = rn <= tol2
        done_h, rn_h = torch.stack([done.to(rn.dtype), rn]).tolist()
        return bool(done_h), rn_h

    history = np.full((maxiter + 1,), np.nan, dtype=np.float32)
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    done, rn = res_ok(r)
    history[0] = rn
    div = rn > divtol
    k = 0
    while not done and not div and k < maxiter:
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, one)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = z + beta * p
        rz = rz_new
        done, rn = res_ok(r)
        k += 1
        history[k] = rn
        div = rn > divtol
    return SolveResult(x, k, rn, done, history, div)


def cg_fixed(A, b, x0=None, M=None, iters: int = 10, mesh=None):
    """``iters`` steps of preconditioned CG on A x = b from x0 (zeros).

    A, M: callables tensor -> tensor.  Two shortcuts leave x unchanged:
    with x0 absent the first residual is b itself (porotpu multiplies A
    by the zero vector), and the last step skips the preconditioner apply
    and the direction update, which only the next step would read.
    """
    if M is None:
        M = lambda r: r  # noqa: E731
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    if iters <= 0:
        return x
    dot = torch.dot if mesh is None else mesh.dot
    z = M(r)
    p = z
    rz = dot(r, z)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for k in range(iters):
        Ap = A(p)
        pAp = dot(p, Ap)
        safe = pAp.abs() > 0
        alpha = torch.where(safe, rz / torch.where(safe, pAp, one), zero)
        x = x + alpha * p
        if k == iters - 1:
            break
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        nz = rz != 0
        beta = torch.where(nz, rz_new / torch.where(nz, rz, one), zero)
        p = z + beta * p
        rz = rz_new
    return x

"""Fixed-iteration preconditioned CG (porotpu/solvers/cg.py:cg_fixed).

The inner solves of the ``cg`` and ``cg+amg`` kinds: a static count of
CG steps and no convergence test, so the loop never reads a value back
from the device.  The zero guards on p.Ap and r.z are ``torch.where``s
on device scalars, as porotpu's ``jnp.where``s.

The outer, tolerance-based ``cg`` is not ported yet (ROADMAP M7.3).
"""

from __future__ import annotations

import torch


def cg_fixed(A, b, x0=None, M=None, iters: int = 10):
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
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for k in range(iters):
        Ap = A(p)
        pAp = torch.dot(p, Ap)
        safe = pAp.abs() > 0
        alpha = torch.where(safe, rz / torch.where(safe, pAp, one), zero)
        x = x + alpha * p
        if k == iters - 1:
            break
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        nz = rz != 0
        beta = torch.where(nz, rz_new / torch.where(nz, rz, one), zero)
        p = z + beta * p
        rz = rz_new
    return x

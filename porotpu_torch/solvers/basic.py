"""Trivial solver types: preonly and (damped) Richardson
(porotpu/solvers/basic.py).

PETSc parity: ``-ksp_type preonly`` (one PC application, the reference's
exact inner solves, petsc-options-exact:11-35) and ``-ksp_type richardson``.
Richardson runs a fixed count of steps, so it never reads a value back
from the device.
"""

from __future__ import annotations

import torch


def preonly(A, b, M, x0=None):
    """x = M(b): single preconditioner application."""
    del A, x0
    return M(b)


def richardson(A, b, M=None, omega=1.0, iters=10, x0=None):
    """Damped preconditioned Richardson: x += omega * M(b - A x)."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iters):
        x = x + omega * M(b - A(x))
    return x

"""Chebyshev semi-iteration and spectrum estimation (porotpu/solvers/chebyshev.py).

``chebyshev`` is the inner solve of the ``chebyshev`` kind: a fixed polynomial in M^-1 A
over [lmin, lmax], the three-term recurrence of Saad, "Iterative
Methods", algorithm 12.1.  The recurrence scalars are host floats, so the
loop never reads a value back from the device.  The bounds come from the
host's power iteration at setup (``precond.amg._power_lmax``);
``estimate_spectrum`` is porotpu's device power iteration, from a seeded
torch start vector where porotpu draws it from ``jax.random``.
"""

from __future__ import annotations

import torch


def estimate_spectrum(A, n, iters=20, M=None, key=None, dtype=torch.float32,
                      device="cuda", mesh=None):
    """Estimate lambda_max of (M^-1 A) by power iteration (setup): the norm
    of the last iterate, as a float.  ``key`` seeds the start vector.  It
    runs on the card and raises without one, unless ``device="cpu"``.
    With ``mesh`` (vectors in slabs of a single field of ``n`` rows) each
    rank starts from its slab of the same vector and the norms are
    reduced over the ranks."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "estimate_spectrum: torch sees no CUDA card; pass device='cpu' to run on the host"
        )
    if M is None:
        M = lambda r: r  # noqa: E731
    norm = torch.linalg.norm if mesh is None else mesh.norm
    gen = torch.Generator().manual_seed(0 if key is None else int(key))
    v = torch.randn(n, generator=gen, dtype=dtype)
    v = (v if mesh is None else mesh.slab(v)).to(device)
    v = v / norm(v)
    nw = torch.zeros((), dtype=dtype, device=device)
    for _ in range(iters):
        w = M(A(v))
        nw = norm(w)
        v = w / torch.where(nw > 0, nw, torch.ones_like(nw))
    return float(nw)


def chebyshev(A, b, lmin, lmax, iters=10, M=None, x0=None):
    """Chebyshev iteration targeting eigenvalues of M^-1 A in [lmin, lmax].

    With x0 absent the first residual is b itself (porotpu multiplies A
    by the zero vector).
    """
    if M is None:
        M = lambda r: r  # noqa: E731
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    d = M(r) / theta
    rho = 1.0 / sigma1
    for _ in range(iters):
        x = x + d
        r = r - A(d)
        z = M(r)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
    return x + d

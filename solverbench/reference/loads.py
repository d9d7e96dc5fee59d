"""Surface loads of the published problems, each scaled by a seeded factor.

A load evaluates ``eval(t, x, n)`` at physical points ``x`` (npts, dim)
with outward unit normals ``n``, the interface of the port's loads.  They
are the reference's alone: the port runs its own load objects, as its
driver builds them, scaled by the same factor.
"""

from __future__ import annotations

import numpy as np


class ScaledNormalLoad:
    """``factor * scale * ramp(t) * n``: swelling's normal traction
    (upstream swelling.py:35-40), ramp(t) = 1 - exp(-t^2 / 0.25)."""

    def __init__(self, scale: float, factor: float):
        self.scale = float(scale)
        self.factor = float(factor)

    def eval(self, t, x, n=None):
        if n is None:
            raise ValueError("a normal load needs the facet normals")
        ramp = 1.0 - np.exp(-(t**2) / 0.25)
        return float(self.factor * self.scale * ramp) * n


class FootingStripLoad:
    """``factor * (0, -min(t, 1) * 1e5)`` under the strip |x - L/2| < L/4 of
    the top, zero elsewhere (upstream footing.py:37-39)."""

    def __init__(self, length: float, factor: float):
        self.length = float(length)
        self.factor = float(factor)

    def eval(self, t, x, n=None):
        val = self.factor * min(t, 1.0) * 1e5
        out = np.zeros((x.shape[0], 2))
        out[:, 1] = np.where(np.abs(x[:, 0] - self.length / 2) < self.length / 4, -val, 0.0)
        return out

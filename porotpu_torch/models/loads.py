# Copy of porotpu/models/loads.py, behaviour unchanged.
"""Load (forcing-term) API for surface and volume loads.

The reference passes loads as closures ``t -> UFL expression``
(lib/AbstractPhysics.py:61-63; e.g. footing.py:37-39 component expression,
swelling.py:35-40 ``c(t) * FacetNormal``).  Here a load is an object whose
``eval(t, x, n)`` returns values at physical points ``x`` (npts, dim) with
outward unit normals ``n`` (npts, dim) for surface loads.
"""

from __future__ import annotations

import numpy as np


class Load:
    def eval(self, t, x, n=None):  # pragma: no cover - interface
        raise NotImplementedError


class ZeroLoad(Load):
    """Zero vector/scalar load (the default for unused slots)."""

    def __init__(self, ncomp=None):
        self.ncomp = ncomp

    def eval(self, t, x, n=None):
        npts = x.shape[0]
        if self.ncomp is None:
            return np.zeros(npts)
        return np.zeros((npts, self.ncomp))


class ConstantLoad(Load):
    """Constant (possibly time-dependent via scale_fn) vector/scalar load."""

    def __init__(self, value, scale_fn=None):
        self.value = np.asarray(value, dtype=float)
        self.scale_fn = scale_fn

    def eval(self, t, x, n=None):
        s = 1.0 if self.scale_fn is None else float(self.scale_fn(t))
        npts = x.shape[0]
        if self.value.ndim == 0:
            return np.full(npts, s * float(self.value))
        return np.tile(s * self.value, (npts, 1))


class NormalLoad(Load):
    """scale(t) * n — normal traction (reference swelling.py:35-40)."""

    def __init__(self, scale_fn):
        self.scale_fn = scale_fn

    def eval(self, t, x, n=None):
        assert n is not None, "NormalLoad requires facet normals"
        return float(self.scale_fn(t)) * n


class ExprLoad(Load):
    """General pointwise expression: fn(t, x) -> (npts, ncomp) or (npts,).

    (reference footing.py:37-39: component-wise conditional expression)
    """

    def __init__(self, fn):
        self.fn = fn

    def eval(self, t, x, n=None):
        return np.asarray(self.fn(t, x), dtype=float)

"""The 2D footing problem (upstream footing.py): the plain reference's
statement of it, from the published driver.

Square of side 64 with two rounds of local refinement under the footing,
E=3e4, nu=0.2, a ramped strip load on the top centre (|x - L/2| < L/4),
solid fixed at the bottom, no fluid flux under the footing, p = 0 on the
rest of the top.  ``loads`` maps the port's load slots to the seeded loads.
"""

from __future__ import annotations

import numpy as np

from .fem.bcs import DirichletBC
from .fem.mesh import generate_boundary_measure, generate_footing_square
from .loads import FootingStripLoad

LENGTH = 64.0
E, NU = 3e4, 0.2
PARAMETERS = {
    "dt": 0.1,
    "mu_f": 1e-3,
    "rhof": 1e3,
    "rhos": 500.0,
    "phi0": 1e-3,
    "mu_s": E / (2 * (1 + NU)),
    "lmbda": E * NU / ((1 + NU) * (1 - 2 * NU)),
    "ks": 1e6,
    "kf": 1e-7,
    "fe degree solid": 2,
    "fe degree fluid": 2,
    "fe degree pressure": 1,
    "solver rtol": 1e-6,
    "solver atol": 1e-4,
}
LOAD_SLOTS = ("fs_sur",)


def loads(factors: dict) -> dict:
    """The seeded surface loads: slot -> load object."""
    return {"fs_sur": FootingStripLoad(LENGTH, factors["fs_sur"])}


def geometry(N: int, refinements: int = 0):
    """(mesh, markers, dsNs, dsNf, tags) of the footing square."""
    mesh, markers, LEFT, RIGHT, TOP, BOTTOM, NONE = generate_footing_square(N, LENGTH, refinements)
    dsNs = generate_boundary_measure(mesh, markers, [TOP])
    dsNf = generate_boundary_measure(mesh, markers, [])
    return mesh, markers, dsNs, dsNf, dict(LEFT=LEFT, RIGHT=RIGHT, TOP=TOP, BOTTOM=BOTTOM)


def dirichlet(W, markers, tags):
    """The Dirichlet conditions on the system's rows (upstream
    footing.py:100-108): solid and fluid.  The pressure condition off the
    footing is upstream's ``bcs_diff``, which only the 3-way
    preconditioner's diffusion block takes, so the system has none."""

    def near(a, b):
        return np.abs(a - b) < 1e-10 + 1e-10 * abs(b)

    def foot(x):
        return near(x[:, 1], LENGTH) & (np.abs(x[:, 0] - LENGTH / 2) < LENGTH / 4)

    return [
        DirichletBC(W, "s", [0.0, 0.0], markers=markers, tags=[tags["BOTTOM"]]),
        DirichletBC(W, "f", [0.0, 0.0], predicate=foot),
    ]

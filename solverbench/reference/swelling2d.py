"""The 2D swelling problem (upstream swelling.py): the plain reference's
statement of it, from the published driver.

Unit-cm square (side 1e-2), a ramped normal traction split 90/10 between
solid (top and right) and fluid (left), symmetry rollers for the solid,
no-slip fluid on top and bottom.
"""

from __future__ import annotations

from .fem.bcs import DirichletBC
from .fem.mesh import generate_boundary_measure, generate_square
from .loads import ScaledNormalLoad

SIDE = 1e-2
PARAMETERS = {
    "dt": 0.1,
    "mu_f": 0.035,
    "rhof": 1e3,
    "rhos": 1e3,
    "phi0": 0.1,
    "mu_s": 4000.0,
    "lmbda": 700.0,
    "ks": 1e6,
    "kf": 1e-7,
    "fe degree solid": 2,
    "fe degree fluid": 2,
    "fe degree pressure": 1,
    "solver rtol": 1e-6,
    "solver atol": 1e-8,
}
LOAD_SLOTS = ("ff_sur", "fs_sur")


def loads(factors: dict) -> dict:
    """The seeded surface loads: slot -> load object."""
    return {
        "ff_sur": ScaledNormalLoad(-1e3 * 0.1, factors["ff_sur"]),
        "fs_sur": ScaledNormalLoad(-1e3 * 0.9, factors["fs_sur"]),
    }


def geometry(N: int, refinements: int = 0):
    """(mesh, markers, dsNs, dsNf, tags) of the square."""
    mesh, markers, LEFT, RIGHT, TOP, BOTTOM, NONE = generate_square(N, SIDE, refinements)
    dsNs = generate_boundary_measure(mesh, markers, [TOP, RIGHT])
    dsNf = generate_boundary_measure(mesh, markers, [LEFT])
    return mesh, markers, dsNs, dsNf, dict(LEFT=LEFT, RIGHT=RIGHT, TOP=TOP, BOTTOM=BOTTOM)


def dirichlet(W, markers, tags):
    """The Dirichlet conditions on the system's rows (upstream
    swelling.py:95-110): solid rollers and no-slip fluid.  The pressure
    conditions are upstream's ``bcs_diff``, which only the 3-way
    preconditioner's diffusion block takes."""
    L, B, T = tags["LEFT"], tags["BOTTOM"], tags["TOP"]
    return [
        DirichletBC(W, "s", 0.0, markers=markers, tags=[L], component=0),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[B], component=1),
        DirichletBC(W, "f", [0.0, 0.0], markers=markers, tags=[T]),
        DirichletBC(W, "f", [0.0, 0.0], markers=markers, tags=[B]),
    ]

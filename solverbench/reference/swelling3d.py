"""The 3D swelling problem (upstream swelling-3d.py): the plain
reference's statement of it, from the published driver.

Unit-cm cube (side 1e-2) in tetrahedra, a ramped normal traction split
90/10 between solid (the faces XP, YP, ZP) and fluid (XM, YM), a
symmetry roller for the solid on each of XM, YM and ZM, no-slip fluid on
ZM and ZP, and a stiffer solid constituent than the 2D problem's
(ks = 1e8).
"""

from __future__ import annotations

from .fem.bcs import DirichletBC
from .fem.mesh import generate_boundary_measure, generate_cube
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
    "ks": 1e8,
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
    """(mesh, markers, dsNs, dsNf, tags) of the cube."""
    mesh, markers, XP, XM, YP, YM, ZP, ZM = generate_cube(N, SIDE, refinements)
    dsNs = generate_boundary_measure(mesh, markers, [XP, YP, ZP])
    dsNf = generate_boundary_measure(mesh, markers, [XM, YM])
    return mesh, markers, dsNs, dsNf, dict(XM=XM, YM=YM, ZM=ZM, ZP=ZP)


def dirichlet(W, markers, tags):
    """The Dirichlet conditions on the system's rows (upstream
    swelling-3d.py): a solid roller on each of XM, YM, ZM and no-slip fluid
    on ZM and ZP.  The pressure conditions are upstream's ``bcs_diff``,
    which only the 3-way preconditioner's diffusion block takes."""
    xm, ym, zm, zp = tags["XM"], tags["YM"], tags["ZM"], tags["ZP"]
    return [
        DirichletBC(W, "s", 0.0, markers=markers, tags=[xm], component=0),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[ym], component=1),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[zm], component=2),
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[zm]),
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[zp]),
    ]

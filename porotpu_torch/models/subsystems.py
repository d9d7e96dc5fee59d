# Copy of porotpu/models/subsystems.py, with the drivers' device_of and SubsystemRun added.
"""Single-field and two-field subsystem benchmarks.

Mirrors the reference's standalone drivers:
- solid.py: pure elasticity block (with Darcy self-term) on a cube —
  exercises one elliptic solve (CG + AMG / LU), reference solid.py:95-180.
- fluid-pressure.py: the 2-field fluid/pressure ("fp") subsystem with a
  fieldsplit Schur solve, reference fluid-pressure.py:80-136.  NOTE the
  reference assembles ``r_f + r_f`` (typo at fluid-pressure.py:113,
  dropping the pressure RHS); here the correct ``r_f + r_p`` is assembled.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..fem import assemble
from ..fem.bcs import DirichletBC, apply_bcs_matrix, apply_bcs_vector, bc_dofs_values
from ..fem.dofmap import FunctionSpace, MixedSpace
from ..fem.mesh import generate_boundary_measure, generate_cube
from .abstract import log
from .loads import NormalLoad

# shared physical parameters (solid.py:44-56 / fluid-pressure.py:32-48)
PARAMS = dict(
    mu_f=0.035,
    rhof=1e3,
    rhos=1e3,
    phi0=0.1,
    mu_s=4000.0,
    lmbda=700.0,
    ks=1e6,
    kf=1e-7,
    dt=0.1,
)


def solid_problem(Nelements=10, refinements=0, t=0.1):
    """Assemble the elasticity block system (reference solid.py).

    Returns (A_bc csr, b numpy, V, mesh) with BCs applied.
    """
    side = 1e-2
    mesh, markers, XP, XM, YP, YM, ZP, ZM = generate_cube(
        Nelements, side, refinements
    )
    dsNs = generate_boundary_measure(mesh, markers, [XP, YP, ZP])
    V = FunctionSpace(mesh, 2, vector=True)
    W = MixedSpace({"s": V})

    p = PARAMS
    phis = 1.0 - p["phi0"]
    idt = 1.0 / p["dt"]
    ikf = 1.0 / p["kf"]

    # a_s = rhos/dt^2 phis u.v + hooke(eps u):eps v + phi0^2 ikf idt u.v
    # (solid.py:105-108)
    A = (
        p["rhos"] * idt**2 * phis * assemble.mass(V)
        + assemble.hooke(V, p["mu_s"], p["lmbda"])
        + p["phi0"] ** 2 * ikf * idt * assemble.mass(V)
    ).tocsr()

    ramp = lambda tt: 1.0 - np.exp(-(tt**2) / 0.25)
    fs_sur = NormalLoad(lambda tt: -1e3 * 0.9 * ramp(tt))
    b = assemble.facet_load(V, dsNs, fs_sur, t)

    bcs = [
        DirichletBC(W, "s", 0.0, markers=markers, tags=[XM], component=0),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[YM], component=1),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[ZM], component=2),
    ]
    dofs, vals = bc_dofs_values(bcs)
    A = apply_bcs_matrix(A, dofs)
    b = apply_bcs_vector(b, dofs, vals)
    return A, b, V, mesh


def fluid_pressure_problem(Nelements=10, refinements=0, t=0.1):
    """Assemble the 2-field fp system (reference fluid-pressure.py).

    Returns (blocks dict, b numpy, W, mesh) with BCs applied; blocks keyed
    ("f","f"), ("f","p"), ("p","f"), ("p","p") after BC row surgery on the
    monolithic system.
    """
    side = 1e-2
    mesh, markers, XP, XM, YP, YM, ZP, ZM = generate_cube(
        Nelements, side, refinements
    )
    dsNf = generate_boundary_measure(mesh, markers, [XM, YM])
    Vf = FunctionSpace(mesh, 2, vector=True)
    Qp = FunctionSpace(mesh, 1)
    W = MixedSpace({"f": Vf, "p": Qp})

    p = PARAMS
    phis = 1.0 - p["phi0"]
    phi0 = p["phi0"]
    idt = 1.0 / p["dt"]
    ikf = 1.0 / p["kf"]

    # a_f (fluid-pressure.py:87-91): note drag term is ikf*vf (no us)
    Aff = (
        p["rhof"] * idt * phi0 * assemble.mass(Vf)
        + assemble.eps_eps(Vf, 2.0 * p["mu_f"] * phi0)
        + phi0**2 * ikf * assemble.mass(Vf)
    ).tocsr()
    Df = assemble.div_coupling(Qp, Vf)
    Afp = (-phi0 * Df.T).tocsr()
    Apf = (phi0 * Df).tocsr()
    App = (phis**2 * idt / p["ks"] * assemble.mass(Qp)).tocsr()

    ramp = lambda tt: 1.0 - np.exp(-(tt**2) / 0.25)
    ff_sur = NormalLoad(lambda tt: -1e3 * 0.1 * ramp(tt))
    bf = assemble.facet_load(Vf, dsNf, ff_sur, t)
    bp = np.zeros(Qp.num_dofs)
    b = np.concatenate([bf, bp])

    bcs = [
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[ZM]),
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[ZP]),
    ]
    dofs, vals = bc_dofs_values(bcs)
    nf = Vf.num_dofs
    Amono = sp.bmat([[Aff, Afp], [Apf, App]], format="csr")
    Amono = apply_bcs_matrix(Amono, dofs)
    b = apply_bcs_vector(b, dofs, vals)
    blocks = {
        ("f", "f"): Amono[:nf, :nf].tocsr(),
        ("f", "p"): Amono[:nf, nf:].tocsr(),
        ("p", "f"): Amono[nf:, :nf].tocsr(),
        ("p", "p"): Amono[nf:, nf:].tocsr(),
    }
    return blocks, b, W, mesh


def device_of(name):
    """A subsystem driver's device; a card asked for and absent raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} asked for, but torch sees no CUDA card; pass --device cpu "
            "to run the plain versions on the host".format(name)
        )
    return device


class SubsystemRun:
    """A subsystem driver's system, built on its device and not yet solved
    (``drivers/solid.py``, ``drivers/fluid_pressure.py``).

    ``A`` and ``b`` are the host system with BCs applied, ``E`` its device
    operator, ``M`` the device preconditioner and ``solver(A, b, M)`` the
    outer solve.  ``t_setup`` is the host time from the end of assembly to
    the operators on the device, as porotpu's drivers time it.
    """

    def __init__(self, A, b, E, M, solver, dtype, device, t_setup):
        self.A, self.b, self.E, self.M = A, b, E, M
        self.solver, self.dtype, self.device = solver, dtype, device
        self.t_setup, self.t_solve = t_setup, 0.0
        self.result, self.residual = None, None

    def solve(self):
        """One outer solve; prints porotpu's "Solved in" (setup and solve
        time, as porotpu's) and "Final residual" (||A x - b|| in f64 on the
        host) lines and returns the iteration count."""
        b = torch.as_tensor(self.b, dtype=self.dtype).to(self.device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = self.solver(self.E.matvec, b, self.M)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_solve = time.perf_counter() - t0
        self.result = res
        log("Solved in {} iterations in {}s".format(res.iters, self.t_setup + self.t_solve))
        x = res.x.cpu().numpy().astype(np.float64)
        self.residual = float(np.linalg.norm(self.A @ x - self.b))
        log("Final residual = {:.3e} (|b| = {:.3e})".format(
            self.residual, np.linalg.norm(self.b)))
        return res.iters

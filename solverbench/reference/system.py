"""The 3-field system of one time step, assembled by the plain reference.

The operator is the linearized poromechanics system of Chapelle et al.
in the field-major dofs [solid | fluid | pressure] (upstream
lib/Assembler.py:80-93), with phis = 1 - phi0, idt = 1/dt, ikf = 1/kf:

  A_ss = rhos idt^2 phis Mv_s + Hooke + phi0^2 ikf idt Mv_s
  A_sf = -phi0^2 ikf Msf          A_sp = -phis D_s^T
  A_fs = -phi0^2 ikf idt Mfs      A_ff = rhof idt phi0 Mv_f + 2 mu_f phi0 eps:eps + phi0^2 ikf Mv_f
  A_fp = -phi0 D_f^T              A_ps = phis idt D_s
  A_pf = phi0 D_f                 A_pp = phis^2 idt / ks Mp

and the rows of the Dirichlet dofs replaced by unit rows.  The
right-hand side of the step at time t from the two previous solutions
(backward differences, full residual):

  b_s = loads_s(t) + (2 rhos idt^2 phis + phi0^2 ikf idt) Mv_s us1 - rhos idt^2 phis Mv_s us2
  b_f = loads_f(t) + rhof idt phi0 Mv_f uf1 - phi0^2 ikf idt Mfs us1
  b_p = phis idt D_s us1 + phis^2 idt / ks Mp p1

with the Dirichlet values on their rows.  Everything is float64 SciPy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .fem import assemble
from .fem.bcs import bc_dofs_values
from .fem.dofmap import FunctionSpace, MixedSpace


class System:
    """One problem module (``footing2d``, ``swelling2d``) at size N with
    ``refinements`` rounds of its local refinement and the seeded loads:
    the operator ``A`` and ``rhs(t, x1, x2)``.  ``parameters`` replace the
    problem's published ones (a configuration's own)."""

    def __init__(self, problem, N: int, loads: dict, refinements: int = 0,
                 parameters: dict | None = None):
        p = dict(problem.PARAMETERS, **(parameters or {}))
        self.params = p
        mesh, markers, self.dsNs, self.dsNf, tags = problem.geometry(N, refinements)
        Vs = FunctionSpace(mesh, p["fe degree solid"], vector=True)
        Vf = FunctionSpace(mesh, p["fe degree fluid"], vector=True)
        Qp = FunctionSpace(mesh, p["fe degree pressure"], vector=False)
        self.W = MixedSpace({"s": Vs, "f": Vf, "p": Qp})
        self.Vs, self.Vf = Vs, Vf
        self.loads = loads
        ns, nf, npp = self.W.get_dimensions()
        self.sizes = (ns, nf, npp)
        self.slices = (slice(0, ns), slice(ns, ns + nf), slice(ns + nf, ns + nf + npp))
        self.n = ns + nf + npp

        phi0 = float(p["phi0"])
        phis, idt, ikf = 1.0 - phi0, 1.0 / float(p["dt"]), 1.0 / float(p["kf"])
        rhos, rhof, ks, mu_f = float(p["rhos"]), float(p["rhof"]), float(p["ks"]), float(p["mu_f"])

        Mv_s = assemble.mass(Vs)
        same = Vs.degree == Vf.degree
        Mv_f = Mv_s if same else assemble.mass(Vf)
        Msf = Mv_s if same else assemble.mass_coupling(Vs, Vf)
        Mfs = Mv_s if same else assemble.mass_coupling(Vf, Vs)
        D_s = assemble.div_coupling(Qp, Vs)
        D_f = D_s if same else assemble.div_coupling(Qp, Vf)
        Mp = assemble.mass(Qp)
        hooke = assemble.hooke(Vs, float(p["mu_s"]), float(p["lmbda"]))
        epsf = assemble.eps_eps(Vf, 2.0 * mu_f * phi0)

        blocks = [
            [rhos * idt**2 * phis * Mv_s + hooke + phi0**2 * ikf * idt * Mv_s,
             -(phi0**2) * ikf * Msf, -phis * D_s.T],
            [-(phi0**2) * ikf * idt * Mfs,
             rhof * idt * phi0 * Mv_f + epsf + phi0**2 * ikf * Mv_f, -phi0 * D_f.T],
            [phis * idt * D_s, phi0 * D_f, phis**2 * idt / ks * Mp],
        ]
        A = sp.bmat(blocks, format="csr")
        self.bc_dofs, self.bc_vals = bc_dofs_values(problem.dirichlet(self.W, markers, tags))
        keep = np.ones(self.n)
        keep[self.bc_dofs] = 0.0
        unit = np.zeros(self.n)
        unit[self.bc_dofs] = 1.0
        self.A = (sp.diags(keep) @ A + sp.diags(unit)).tocsr()

        self.hist = (
            (0, "us1", Mv_s, 2.0 * rhos * idt**2 * phis + phi0**2 * ikf * idt),
            (0, "us2", Mv_s, -rhos * idt**2 * phis),
            (1, "uf1", Mv_f, rhof * idt * phi0),
            (1, "us1", Mfs, -(phi0**2) * ikf * idt),
            (2, "us1", D_s, phis * idt),
            (2, "p1", Mp, phis**2 * idt / ks),
        )

    def load_vector(self, t: float) -> np.ndarray:
        b = np.zeros(self.n)
        s, f, _ = self.slices
        if "fs_sur" in self.loads:
            b[s] += assemble.facet_load(self.Vs, self.dsNs, self.loads["fs_sur"], t)
        if "ff_sur" in self.loads:
            b[f] += assemble.facet_load(self.Vf, self.dsNf, self.loads["ff_sur"], t)
        return b

    def rhs(self, t: float, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        """The step's right-hand side at time t after the solutions x1 (the
        last step) and x2 (the one before), zero before the first step."""
        s, f, p = self.slices
        vec = {"us1": x1[s], "us2": x2[s], "uf1": x1[f], "p1": x1[p]}
        b = self.load_vector(t)
        for field, name, M, c in self.hist:
            b[self.slices[field]] += c * (M @ vec[name])
        b[self.bc_dofs] = self.bc_vals
        return b

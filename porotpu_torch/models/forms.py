# Copy of porotpu/models/forms.py; ``assemble`` prints through ``log``.
"""Assembly of the linearized poromechanics operator, preconditioners, RHS.

Re-derives lib/Assembler.py of the reference for the TPU build: the
variational forms (lib/Assembler.py:80-97) are expanded by hand into the
block matrices of the field-major system [solid | fluid | pressure] using
the generic kernels of fem.assemble.  With constant coefficients
each block is a scaled combination of a few primitive matrices (vector
mass, Hooke stiffness, eps:eps, div-div, divergence coupling, scalar
mass/stiffness), assembled once.

System blocks (a_s + a_f + a_p, lib/Assembler.py:80-93), with
phis = 1 - phi0, idt = 1/dt, ikf = 1/kf:

  A_ss = rhos idt^2 phis Mv + Hooke(mu_s, lmbda) + phi0^2 ikf idt Mv
  A_sf = -phi0^2 ikf Msf                 (Darcy drag coupling)
  A_sp = -phis D_s^T                     (-p div(phis v))
  A_fs = -phi0^2 ikf idt Mfs
  A_ff = rhof idt phi0 Mv + 2 mu_f phi0 eps:eps + phi0^2 ikf Mv
  A_fp = -phi0 D_f^T
  A_ps = phis idt D_s
  A_pf = phi0 D_f
  A_pp = phis^2 idt / ks Mp

The five preconditioner variants (lib/Assembler.py:100-219, SURVEY.md
§2.4) modify these blocks; see build_preconditioner_blocks.

RHS (lib/Assembler.py:235-270): the reference *constructs* the full
residual forms r_s/r_f/r_p but line 267 assembles only the load terms —
the history-field terms are dead code in the reference.  Here both modes
exist: rhs_mode="full-residual" (default; the evident intent, history
terms enter through precomputed mass/coupling SpMVs) and
rhs_mode="loads-only" (bug-compatible with the reference's actual
behavior).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..fem import assemble
from ..fem.dofmap import FunctionSpace, MixedSpace
from .abstract import log

FIELDS = ("s", "f", "p")

PC_TYPES = (
    "lu",
    "undrained",
    "diagonal",
    "diagonal 3-way",
    "diagonal 3-way-II",
    "undrained 3-way",
)


class Primitives:
    """The primitive matrices every block is built from — assembled lazily
    (only the variants a given pc type touches get built) with same-degree
    aliasing: when solid and fluid share the P2 space, the four vector
    masses Mv_s/Mv_f/Msf/Mfs are one matrix."""

    def __init__(self, W: MixedSpace, mu_s, lmbda, mu_f, phi0):
        self.W = W
        self._mu_s, self._lmbda = mu_s, lmbda
        self._mu_f, self._phi0 = mu_f, phi0
        self._cache = {}

    def _get(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def _same_deg(self):
        return self.W.space("s").degree == self.W.space("f").degree

    @property
    def Mv_s(self):
        return self._get("Mv_s", lambda: assemble.mass(self.W.space("s")))

    @property
    def Mv_f(self):
        if self._same_deg:
            return self.Mv_s
        return self._get("Mv_f", lambda: assemble.mass(self.W.space("f")))

    @property
    def Msf(self):
        if self._same_deg:
            return self.Mv_s
        return self._get(
            "Msf",
            lambda: assemble.mass_coupling(self.W.space("s"), self.W.space("f")),
        )

    @property
    def Mfs(self):
        if self._same_deg:
            return self.Mv_s
        return self._get(
            "Mfs",
            lambda: assemble.mass_coupling(self.W.space("f"), self.W.space("s")),
        )

    @property
    def Hooke(self):
        return self._get(
            "Hooke",
            lambda: assemble.hooke(self.W.space("s"), self._mu_s, self._lmbda),
        )

    @property
    def EpsF(self):
        return self._get(
            "EpsF",
            lambda: assemble.eps_eps(
                self.W.space("f"), 2.0 * self._mu_f * self._phi0
            ),
        )

    @property
    def DivDiv_s(self):
        return self._get("DivDiv_s", lambda: assemble.divdiv(self.W.space("s")))

    @property
    def DivDiv_f(self):
        if self._same_deg and "DivDiv_s" in self._cache:
            return self._cache["DivDiv_s"]
        return self._get("DivDiv_f", lambda: assemble.divdiv(self.W.space("f")))

    @property
    def D_s(self):
        return self._get(
            "D_s",
            lambda: assemble.div_coupling(self.W.space("p"), self.W.space("s")),
        )

    @property
    def D_f(self):
        if self._same_deg:
            return self.D_s
        return self._get(
            "D_f",
            lambda: assemble.div_coupling(self.W.space("p"), self.W.space("f")),
        )

    @property
    def Mp(self):
        return self._get("Mp", lambda: assemble.mass(self.W.space("p")))

    @property
    def Kp(self):
        return self._get("Kp", lambda: assemble.stiffness(self.W.space("p")))


class PoromechanicsAssembler:
    """Operator factory for the 3-field system (reference lib/Assembler.py).

    Parameters dict uses the reference's keys: mu_s, lmbda, rhos, rhof,
    mu_f, phi0, ks, kf, dt, betas, betaf, betap, pc type, plus the load
    slots dsNs, dsNf, ff_vol, fs_vol, ff_sur, fs_sur, p_source
    (footing.py:46-89).
    """

    def __init__(self, parameters: dict, W: MixedSpace, three_way: bool):
        self.parameters = parameters
        self.W = W
        self.three_way = three_way
        self.prec_type = parameters["pc type"]
        self.dim = W.space("s").mesh.dim

        p = parameters
        self.mu_s = float(p["mu_s"])
        self.lmbda = float(p["lmbda"])
        self.rhos = float(p["rhos"])
        self.rhof = float(p["rhof"])
        self.mu_f = float(p["mu_f"])
        self.phi0 = float(p["phi0"])
        self.ks = float(p["ks"])
        self.kf = float(p["kf"])
        self.dt = float(p["dt"])
        self.betas = float(p.get("betas", -0.5))
        self.betaf = float(p.get("betaf", 0.0))
        self.betap = float(p.get("betap", 1.0))

        self.phis = 1.0 - self.phi0
        self.idt = 1.0 / self.dt
        self.ikf = 1.0 / self.kf

        # loads
        self.dsNs = p["dsNs"]
        self.dsNf = p["dsNf"]
        self.ff_vol = p.get("ff_vol")
        self.fs_vol = p.get("fs_vol")
        self.ff_sur = p.get("ff_sur")
        self.fs_sur = p.get("fs_sur")
        self.p_source = p.get("p_source")

        self.rhs_mode = p.get("rhs mode", "full-residual")

        self.A_blocks = None
        self.P_blocks = None
        self.P_diff_pp = None

    # -- system matrix ------------------------------------------------------

    def assemble(self):
        import time as _time

        t0 = _time.perf_counter()
        W = self.W
        pr = Primitives(W, self.mu_s, self.lmbda, self.mu_f, self.phi0)
        self.pr = pr

        phis, phi0 = self.phis, self.phi0
        idt, ikf, ks = self.idt, self.ikf, self.ks
        rhos, rhof = self.rhos, self.rhof

        A = {}
        A["s", "s"] = (
            rhos * idt**2 * phis * pr.Mv_s + pr.Hooke + phi0**2 * ikf * idt * pr.Mv_s
        ).tocsr()
        A["s", "f"] = (-(phi0**2) * ikf * pr.Msf).tocsr()
        A["s", "p"] = (-phis * pr.D_s.T).tocsr()
        A["f", "s"] = (-(phi0**2) * ikf * idt * pr.Mfs).tocsr()
        A["f", "f"] = (
            rhof * idt * phi0 * pr.Mv_f + pr.EpsF + phi0**2 * ikf * pr.Mv_f
        ).tocsr()
        A["f", "p"] = (-phi0 * pr.D_f.T).tocsr()
        A["p", "s"] = (phis * idt * pr.D_s).tocsr()
        A["p", "f"] = (phi0 * pr.D_f).tocsr()
        A["p", "p"] = (phis**2 * idt / ks * pr.Mp).tocsr()
        self.A_blocks = A

        self.P_blocks, self.P_diff_pp = self.build_preconditioner_blocks(A)
        log(
            "---- [Assembler] Assembly A, P time = {}s".format(
                _time.perf_counter() - t0
            )
        )

    def build_preconditioner_blocks(self, A):
        """The five physics-based preconditioner variants (SURVEY.md §2.4)."""
        pr = self.pr
        phis, phi0 = self.phis, self.phi0
        idt, ikf, ks = self.idt, self.ikf, self.ks
        rhos, rhof = self.rhos, self.rhof
        d = self.dim
        pc = self.prec_type

        beta_p = self.betap * phis**2 / (self.dt * (2.0 * self.mu_s / d + self.lmbda))
        beta_CC1 = phi0 / (2.0 * self.mu_f / d)
        beta_CC2 = 1.0 / (rhof * idt / phi0 + ikf)
        N = ks / phis**2

        P = {k: v for k, v in A.items()}  # start from A ("lu" keeps it)
        P_diff_pp = None

        if pc == "undrained":
            # a_s: + N div(phis us) div(phis v); drops vf and p couplings
            # (lib/Assembler.py:100-117)
            P["s", "s"] = (A["s", "s"] + N * phis**2 * pr.DivDiv_s).tocsr()
            P.pop(("s", "f"))
            P.pop(("s", "p"))
        elif pc == "undrained 3-way":
            # (lib/Assembler.py:118-138)
            P["s", "s"] = (A["s", "s"] + N * phis**2 * pr.DivDiv_s).tocsr()
            P.pop(("s", "f"))
            P.pop(("s", "p"))
            P["p", "p"] = (phis**2 * idt / ks * pr.Mp + beta_CC1 * pr.Mp).tocsr()
            P.pop(("p", "s"))
            P.pop(("p", "f"))
            P_diff_pp = (phis**2 * idt / ks * pr.Mp + beta_CC2 * pr.Kp).tocsr()
        elif pc == "diagonal":
            # (lib/Assembler.py:139-161)
            P["s", "s"] = (
                rhos * idt**2 * phis * pr.Mv_s
                + pr.Hooke
                + (1.0 + self.betas) * phi0**2 * ikf * idt * pr.Mv_s
            ).tocsr()
            P["f", "f"] = (
                rhof * idt * phi0 * pr.Mv_f
                + pr.EpsF
                + (1.0 + self.betaf) * phi0**2 * ikf * pr.Mv_f
            ).tocsr()
            P.pop(("f", "s"))  # drag us coupling dropped in a_f
            P["p", "p"] = (A["p", "p"] + beta_p * pr.Mp).tocsr()
            P.pop(("p", "s"))  # solid divergence dropped in a_p
        elif pc == "diagonal 3-way":
            # (lib/Assembler.py:162-189)
            P["s", "s"] = (
                rhos * idt**2 * phis * pr.Mv_s
                + pr.Hooke
                + (1.0 + self.betas) * phi0**2 * ikf * idt * pr.Mv_s
            ).tocsr()
            P["f", "f"] = (
                rhof * idt * phi0 * pr.Mv_f
                + pr.EpsF
                + (1.0 + self.betaf) * phi0**2 * ikf * pr.Mv_f
            ).tocsr()
            P.pop(("f", "s"))
            P["p", "p"] = (
                phis**2 * idt / ks * pr.Mp + (beta_p + beta_CC1) * pr.Mp
            ).tocsr()
            P.pop(("p", "s"))
            P.pop(("p", "f"))
            P_diff_pp = (
                phis**2 * idt / ks * pr.Mp + beta_p * pr.Mp + beta_CC2 * pr.Kp
            ).tocsr()
        elif pc == "diagonal 3-way-II":
            # (lib/Assembler.py:190-211): grad-div augmented fluid block,
            # no p coupling in a_f; assembled 2-way
            P["s", "s"] = (
                rhos * idt**2 * phis * pr.Mv_s
                + pr.Hooke
                + (1.0 + self.betas) * phi0**2 * ikf * idt * pr.Mv_s
            ).tocsr()
            gd = 1.0 / (phis**2 * idt / ks + beta_p)
            P["f", "f"] = (
                rhof * idt * phi0 * pr.Mv_f
                + pr.EpsF
                + gd * phi0**2 * pr.DivDiv_f
                + (1.0 + self.betaf) * phi0**2 * ikf * pr.Mv_f
            ).tocsr()
            P.pop(("f", "s"))
            P.pop(("f", "p"))
            P["p", "p"] = (A["p", "p"] + beta_p * pr.Mp).tocsr()
            P.pop(("p", "s"))
        elif pc == "lu":
            pass  # P = A
        else:
            raise ValueError(f"unknown pc type {pc}")

        return P, P_diff_pp

    # -- accessors (reference API parity) -----------------------------------

    def getMatrix(self):
        return self.A_blocks

    def getPreconditioners(self):
        return self.P_blocks, self.P_diff_pp

    # -- RHS ----------------------------------------------------------------

    def get_load_vector(self, t: float) -> np.ndarray:
        """Assemble the load part of the RHS at time t (host, boundary-only).

        reference lib/Assembler.py:243,250-251,259 (surface + volume loads).
        """
        W = self.W
        Vs, Vf, Qp = W.space("s"), W.space("f"), W.space("p")
        b = np.zeros(W.num_dofs)
        ss, fs, ps = (W.field(k).slice for k in FIELDS)

        if self.fs_sur is not None:
            b[ss] += assemble.facet_load(Vs, self.dsNs, self.fs_sur, t)
        if self.ff_sur is not None:
            b[fs] += assemble.facet_load(Vf, self.dsNf, self.ff_sur, t)
        # volume loads (zero in all reference drivers, but a stated
        # capability: arbitrary expression-valued fs_vol/ff_vol/p_source,
        # lib/Assembler.py:243-259).  Loads are evaluated pointwise at the
        # space's nodes and integrated as the interpolant (assemble.
        # cell_load nodal path); spatially-constant values take the
        # cheaper closed-form path.
        if self.fs_vol is not None:
            b[ss] += self.phis * self.rhos * self._vol_load(Vs, self.fs_vol, t)
        if self.ff_vol is not None:
            b[fs] += self.phi0 * self.rhof * self._vol_load(Vf, self.ff_vol, t)
        if self.p_source is not None:
            b[ps] += (1.0 / self.rhof) * self._vol_load(Qp, self.p_source, t)
        return b

    def _vol_load(self, space, load, t) -> np.ndarray:
        """∫ f . v dx for a pointwise volume load object (models/loads.py)."""
        x = space.node_coords
        v = np.asarray(load.eval(t, x), dtype=float)
        ncomp = space.ncomp if space.vector else 1
        # broadcast scalars / per-component constants to (n_nodes, ncomp)
        if v.ndim == 0 or (v.ndim == 1 and space.vector and v.size == ncomp):
            v = np.broadcast_to(v, (x.shape[0], ncomp) if space.vector else (x.shape[0],))
        if not np.any(v != 0):
            return 0.0
        if space.vector:
            vals = np.broadcast_to(np.atleast_2d(v), (x.shape[0], ncomp))
            if (vals == vals[0]).all():
                return assemble.cell_load(space, f_const=vals[0])
            return assemble.cell_load(space, f_at_nodes=vals.ravel())
        vals = np.broadcast_to(v.ravel(), (x.shape[0],))
        if (vals == vals[0]).all():
            return assemble.cell_load(space, f_const=float(vals[0]))
        return assemble.cell_load(space, f_at_nodes=vals)

    def history_terms(self):
        """History-field RHS contributions in factored form.

        r_s += rhos idt^2 phis Mv (2 us1 - us2) + phi0^2 ikf idt Mv us1
        r_f += rhof idt phi0 Mv uf1 - phi0^2 ikf idt Mfs us1
        r_p += phis idt D_s us1 + phis^2/(ks dt) Mp p1
        (derived from lib/Assembler.py:245-264 with r = rhs - lhs)

        Every matrix is a *scalar multiple* of a shared primitive, so the
        return value is (ops, terms): ``ops`` maps name -> csr matrix
        (deduplicated — typically just Mv, D_s, Mp), and ``terms`` maps
        (field, history_field) -> (op_name, scalar).  This keeps the
        device footprint to three SpMV operands instead of six.
        """
        return self.history_ops(), self.history_term_spec()

    def history_term_spec(self):
        """(field, history_field) -> (op_name, scalar); no assembly."""
        phis, phi0 = self.phis, self.phi0
        idt, ikf, ks = self.idt, self.ikf, self.ks
        same = (
            self.W.space("s").degree == self.W.space("f").degree
        )
        mv_f = "Mv_s" if same else "Mv_f"
        mfs = "Mv_s" if same else "Mfs"
        return {
            ("s", "us1"): ("Mv_s", 2.0 * self.rhos * idt**2 * phis
                           + phi0**2 * ikf * idt),
            ("s", "us2"): ("Mv_s", -self.rhos * idt**2 * phis),
            ("f", "uf1"): (mv_f, self.rhof * idt * phi0),
            ("f", "us1"): (mfs, -(phi0**2) * ikf * idt),
            ("p", "us1"): ("D_s", phis * idt),
            ("p", "p1"): ("Mp", phis**2 * idt / ks),
        }

    def history_ops(self):
        """name -> csr matrix for the ops referenced by history_term_spec."""
        pr = self.pr
        ops = {"Mv_s": pr.Mv_s, "D_s": pr.D_s, "Mp": pr.Mp}
        if pr.Mv_f is not pr.Mv_s:
            ops["Mv_f"] = pr.Mv_f
        if pr.Mfs is not pr.Mv_s:
            ops["Mfs"] = pr.Mfs
        return ops

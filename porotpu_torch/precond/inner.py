"""Inner (per-field) approximate solvers (porotpu/precond/inner.py).

Kinds: ``identity``; ``jacobi`` (diagonal scaling); ``lu`` (the dense
inverse, computed on the host in f64, applied as one matrix-vector
product); ``chebyshev`` and ``cg`` (fixed-iteration, Jacobi
preconditioned); ``amg`` (preonly V-cycles, the bench path's hypre
stand-in); ``cg+amg`` (fixed-iteration CG preconditioned by one V-cycle,
the drivers' default); ``plus-diag`` (the additive composite of the dcc
Schur solver); ``fgmres+fs`` (the quasi-exact fluid-pressure solve:
FGMRES on the saddle fp operator, preconditioned by the Schur
fieldsplit, until rtol 1e-12 or its iteration count).  Every banded
product goes through ``ops.dia`` (K1, or K2 for a transpose, on the
card).

On a row mesh (``parallel.sharding``) ``mesh`` and ``fields`` (the
block's local field sizes) are set: the CG kinds reduce their dot
products over the ranks, ``fgmres+fs`` its CGS2 passes, norms and stop
test, and ``lu`` gathers its input field by field for the replicated
inverse and keeps its slabs of the product.

``remap_inner_iters`` applies ``inner iters`` to a restored solver
cache's PC; ``set_inner_monitor`` turns on the per-field inner monitors
(reference lib/Preconditioner.py:94-100): after each apply of a solver
that holds its block operator, ``|b - A x|`` is printed under the
block's label, at the cost of one more product and one host read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
from torch import nn

from ..ops.dia import device_matrix
from ..solvers.cg import cg_fixed
from ..solvers.chebyshev import chebyshev
from ..solvers.gmres import fgmres
from ..utils import trace
from .amg import _power_lmax, amg_setup


@dataclass
class InnerConfig:
    """Configuration of one inner solve (porotpu/precond/inner.py:35-90)."""

    method: str = "cg+amg"  # jacobi | chebyshev | cg | cg+amg | amg | lu
    iters: int = 5  # fixed iteration count for cg/chebyshev
    sweeps: int = 1  # AMG V-cycles per application
    amg_theta: float = 0.08
    amg_coarse_size: int = 600
    amg_presmooth: int = 2
    amg_postsmooth: int = 2
    amg_box_factor: float | None = None  # None = 2.0 in 2D, 3.0 in 3D
    amg_smooth_degree: int = 1
    amg_cheb_lower: float = 4.0
    amg_p_drop: float = 0.0
    lu_max_size: int = 20000
    lu_fallback_iters: int = 40
    cheb_frac: float = 30.0

    @classmethod
    def from_reference_options(cls, ksp_type: str, pc_type: str, maxiter: int = 10):
        """Map reference (inner ksp type, inner pc type) pairs onto methods:
        hypre->amg, lu/mumps->lu, none->jacobi (lib/Preconditioner.py:94-100)."""
        pc = (pc_type or "").lower()
        ksp = (ksp_type or "").lower()
        if pc in ("lu", "mumps", "cholesky"):
            return cls(method="lu")
        if pc in ("hypre", "gamg", "amg", "boomeramg"):
            if ksp in ("preonly", ""):
                return cls(method="amg")
            return cls(method="cg+amg", iters=min(maxiter, 10))
        if pc in ("jacobi", "bjacobi", "none"):
            if ksp in ("preonly", ""):
                return cls(method="jacobi")
            return cls(method="cg", iters=min(maxiter, 20))
        return cls(method="chebyshev", iters=min(maxiter, 10))


KINDS = (
    "identity", "jacobi", "lu", "chebyshev", "cg", "amg", "cg+amg", "plus-diag", "fgmres+fs",
)
# the kinds whose iteration count "inner iters" sets
ITERATED = ("cg+amg", "cg", "chebyshev", "amg")
# an inner monitor's line, porotpu's format (porotpu/precond/inner.py:130)
MONITOR_LINE = "  [inner {label}] |r|={r:.4e}"


class InnerSolver(nn.Module):
    """An approximate solve b -> x for one block.

    ``payload`` maps names to modules (``amg``, ``A``, ``base``, ``fs``) or tensors
    (``dinv``, ``inv``, ``wdiag``); modules become submodules and tensors
    buffers, so ``.to(device)`` moves the whole solver.  With ``monitor``
    each apply of a kind that holds ``A`` prints its residual under
    ``label`` (porotpu/precond/inner.py:127-134).
    """

    mesh = None  # the row mesh, when sharded
    fields = None  # the block's local field sizes, when sharded

    def __init__(self, kind, payload=None, iters=0, lmax=1.0, cheb_frac=30.0,
                 monitor=False, label=""):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown inner solver kind {kind!r}; kinds: {', '.join(KINDS)}")
        self.kind = kind
        self.iters = iters
        self.lmax = float(lmax)
        self.cheb_frac = float(cheb_frac)
        self.monitor = bool(monitor)
        self.label = label
        payload = payload or {}
        self.mods = nn.ModuleDict(
            {k: v for k, v in payload.items() if isinstance(v, nn.Module)}
        )
        for k, v in payload.items():
            if isinstance(v, torch.Tensor):
                self.register_buffer(k, v)

    def _jacobi(self, r):
        return self.dinv * r

    def forward(self, b):
        x = self._solve(b)
        if self.monitor and "A" in self.mods:
            res = b - self.mods["A"].matvec(x)
            r = trace.host_read(torch.linalg.vector_norm(res) if self.mesh is None
                                else self.mesh.norm(res))
            print(MONITOR_LINE.format(label=self.label or self.kind, r=r), flush=True)
        return x

    def _solve(self, b):
        k = self.kind
        if k == "identity":
            return b
        if k == "jacobi":
            return self.dinv * b
        if k == "lu":
            # porotpu computes this product outside any Pallas kernel too
            if self.mesh is not None:
                return self._sharded_lu(b)
            return torch.mv(self.inv, b)
        if k == "chebyshev":
            return chebyshev(
                self.mods["A"].matvec, b, self.lmax / self.cheb_frac, 1.1 * self.lmax,
                iters=self.iters, M=self._jacobi,
            )
        if k == "cg":
            return cg_fixed(self.mods["A"].matvec, b, M=self._jacobi, iters=self.iters,
                            mesh=self.mesh)
        if k == "cg+amg":
            return cg_fixed(self.mods["A"].matvec, b, M=self.mods["amg"], iters=self.iters,
                            mesh=self.mesh)
        if k == "amg":
            amg = self.mods["amg"]
            x = amg(b)
            for _ in range(self.iters - 1):
                x = x + amg(b - self.mods["A"].matvec(x))
            return x
        if k == "fgmres+fs":
            # the quasi-exact fp solve (porotpu/precond/inner.py:180-198):
            # the count or rtol 1e-12 stops it, whichever comes first; the
            # stop is decided on the host each iteration, as the outer solve's
            res = fgmres(
                self.mods["A"].matvec, b, M=self.mods["fs"], rtol=1e-12, atol=0.0,
                maxiter=self.iters, restart=self.iters, mesh=self.mesh,
            )
            return res.x
        # plus-diag: y = S_md^-1 b + w_visc diag^-1 b (precond/schur.py dcc)
        return self.mods["base"](b) + self.wdiag * b

    def _sharded_lu(self, b):
        """The replicated inverse on the whole block: each field gathered,
        the product's slabs kept."""
        mesh, parts, off = self.mesh, [], 0
        for n in self.fields:
            parts.append(mesh.all_gather(b[off : off + n]))
            off += n
        y = torch.mv(self.inv, torch.cat(parts))
        out, off = [], 0
        for n in self.fields:
            out.append(mesh.slab(y[off : off + n * mesh.world]))
            off += n * mesh.world
        return torch.cat(out)


# the block PC's inner solves and their monitor labels, the reference's
# per-field prefixes (lib/Preconditioner.py:77-92)
BLOCK_LABELS = {"solve_s": "s", "solve_fp": "fp", "solve_f": "f", "solve_p": "p",
                "solve_diff": "diff"}


def remap_inner_iters(obj, iters: int):
    """Set the iteration count of every iterated inner solve of a PC tree
    in place, and return the tree (porotpu/precond/inner.py:202-247):
    applies ``inner iters`` to a PC restored from a solver cache that was
    built with another count; the payloads are reused as they are."""
    from .block import BlockPreconditioner, CastPC
    from .schur import SchurFieldsplit

    if isinstance(obj, InnerSolver):
        if obj.kind in ITERATED:
            obj.iters = int(iters)
        elif obj.kind == "plus-diag":
            remap_inner_iters(obj.mods["base"], iters)
    elif isinstance(obj, SchurFieldsplit):
        remap_inner_iters(obj.solve_f, iters)
        remap_inner_iters(obj.solve_S, iters)
    elif isinstance(obj, BlockPreconditioner):
        for attr in BLOCK_LABELS:
            remap_inner_iters(getattr(obj, attr), iters)
    elif isinstance(obj, CastPC):
        remap_inner_iters(obj.inner, iters)
    return obj


def set_inner_monitor(obj, enable: bool, label: str = ""):
    """Turn the inner monitors of a PC tree on or off in place, and return
    the tree (porotpu/precond/inner.py:249-298).  The block PC's solves
    take ``BLOCK_LABELS``, a Schur fieldsplit's ``<label>_f`` and
    ``<label>_S`` (``fp_f``, ``fp_S``), the dcc Schur's base solve its
    composite's label."""
    from .block import BlockPreconditioner, CastPC
    from .schur import SchurFieldsplit

    if isinstance(obj, InnerSolver):
        obj.monitor = bool(enable)
        obj.label = label or obj.label
        if obj.kind == "plus-diag":
            set_inner_monitor(obj.mods["base"], enable, obj.label)
    elif isinstance(obj, SchurFieldsplit):
        set_inner_monitor(obj.solve_f, enable, (label or "fp") + "_f")
        set_inner_monitor(obj.solve_S, enable, (label or "fp") + "_S")
    elif isinstance(obj, BlockPreconditioner):
        for attr, lab in BLOCK_LABELS.items():
            child = getattr(obj, attr)
            if isinstance(child, (InnerSolver, SchurFieldsplit)):
                set_inner_monitor(child, enable, lab)
    elif isinstance(obj, CastPC):
        set_inner_monitor(obj.inner, enable, label)
    return obj


def build_inner_solver(
    A: sp.csr_matrix,
    cfg: InnerConfig,
    dofs_per_node: int = 1,
    near_nullspace: np.ndarray | None = None,
    coords: np.ndarray | None = None,
    dtype=torch.float32,
) -> InnerSolver:
    """Host setup of one inner solver (porotpu/precond/inner.py:300-368)."""
    method = cfg.method
    if method == "lu" and A.shape[0] > cfg.lu_max_size:
        # above the dense cap: tight CG + AMG at default AMG settings
        method = "cg+amg"
        cfg = InnerConfig(method="cg+amg", iters=cfg.lu_fallback_iters)
    if method == "identity":
        return InnerSolver("identity")

    diag = np.asarray(A.diagonal()).ravel()
    diag[diag == 0] = 1.0
    dinv = torch.as_tensor(1.0 / diag, dtype=dtype)
    if method == "jacobi":
        return InnerSolver("jacobi", {"dinv": dinv})
    if method == "lu":
        # raises LinAlgError on a singular block: no fallback
        inv = sla.inv(np.asarray(A.todense(), dtype=np.float64))
        return InnerSolver("lu", {"inv": torch.as_tensor(inv, dtype=dtype)})
    if method == "chebyshev":
        return InnerSolver(
            "chebyshev",
            {"A": device_matrix(A, dtype), "dinv": dinv},
            iters=cfg.iters,
            lmax=_power_lmax(A, 1.0 / diag),
            cheb_frac=cfg.cheb_frac,
        )
    if method == "cg":
        return InnerSolver("cg", {"A": device_matrix(A, dtype), "dinv": dinv}, iters=cfg.iters)
    if method not in ("amg", "cg+amg"):
        raise ValueError(f"unknown inner method {cfg.method}")
    amg = amg_setup(
        A,
        dofs_per_node=dofs_per_node,
        B=near_nullspace,
        theta=cfg.amg_theta,
        coarse_size=cfg.amg_coarse_size,
        presmooth=cfg.amg_presmooth,
        postsmooth=cfg.amg_postsmooth,
        coords=coords,
        box_factor=cfg.amg_box_factor,
        smooth_degree=cfg.amg_smooth_degree,
        cheb_lower=cfg.amg_cheb_lower,
        p_drop_tol=cfg.amg_p_drop,
        dtype=dtype,
    )
    # the hierarchy's fine-level operator doubles as the block operator
    Eop = amg.levels[0].A if len(amg.levels) else device_matrix(A, dtype)
    if method == "amg":
        return InnerSolver("amg", {"amg": amg, "A": Eop}, iters=max(cfg.sweeps, 1))
    return InnerSolver("cg+amg", {"amg": amg, "A": Eop}, iters=cfg.iters)

"""The 3-field poromechanics problem on PyTorch (porotpu/models/poromechanics.py).

Assembly is the port's copy of porotpu's ``PoromechanicsAssembler``
(``models/forms.py``); the host staging below (BC surgery, padded
layout, near-nullspaces, coordinates) copies porotpu's.  The solver state — the block operator ``A_dev`` and
the block preconditioner ``pc`` — is a tree of ``nn.Module``s built on
the host and moved to ``device`` in one ``.to``.  Each time step is one
outer solve: FGMRES (``solver type`` gmres or fgmres), CG or AAR.

Ported: the 2-way block preconditioner with the inexact Schur
fieldsplit or the exact fluid-pressure block (dense LU, or above its cap
the quasi-exact ``fgmres+fs`` solve), the 3-way block
preconditioner (its pressure-diffusion block ``P_diff``), a ``pc dtype``
below the solve dtype (the PC built at that dtype under ``CastPC``),
solver types gmres/fgmres (both run flexible GMRES), cg and aar,
Anderson acceleration of the PC output (``inner accel order``), both RHS modes
(``loads-only`` and the reference drivers' ``full-residual``, whose
history products run on the device operators ``H_dev``), ``solver
chunk``, ``print_timings``, the solver cache (``solver cache path``:
the host-built state pickled before it moves to the device, restored by
``try_load_solver_cache``), the inner monitors (``inner monitor``) and
the export of ``solution_fields``.

On a row mesh (``create_solver(mesh)``, ``parallel.solver_mesh``) each
rank builds the same host setup, keeps its field slabs of every operator
and vector, and runs the outer solve with reductions over the ranks
(porotpu/parallel/sharding.py): every solver type (FGMRES, cg with its
chunks, AAR), ``inner accel order``, every PC the drivers build, the
quasi-exact ``fgmres+fs`` fp solve included.  The right-hand side is
built whole on each rank and sliced; ``unpadded_solution`` and
``solution_fields`` gather.  ``pad multiple`` must be a multiple of the
world size.
"""

from __future__ import annotations

import math
import time as _time

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..fem.bcs import bc_dofs_values, zero_rows
from ..fem.dofmap import FunctionSpace, MixedSpace, vertex_embedding
from ..ops.dia import device_matrix
from ..ops.sparse import FieldMatrix
from ..precond.amg import host_threads, rigid_body_modes
from ..precond.block import BlockPreconditioner, CastPC
from ..precond.inner import (
    ITERATED, InnerConfig, InnerSolver, build_inner_solver, remap_inner_iters, set_inner_monitor,
)
from ..precond.schur import build_schur_fieldsplit
from ..solvers.aar import aar
from ..solvers.cg import cg
from ..solvers.convergence import FieldwiseTest
from ..solvers.gmres import fgmres
from ..utils import trace
from .abstract import AbstractPhysics, log
from .forms import FIELDS, PC_TYPES, PoromechanicsAssembler

DTYPES = {
    "float64": torch.float64, "f64": torch.float64, "double": torch.float64,
    "float32": torch.float32, "f32": torch.float32, "single": torch.float32,
}


def _resolve_dtype(name, default):
    if name is None:
        return default
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unrecognized dtype {name!r}; accepted: {sorted(DTYPES)}")
    return DTYPES[name]


class Poromechanics(AbstractPhysics):
    def __init__(
        self, parameters, mesh, markers=None, parser=None, dtype=torch.float64,
        device="cuda",
    ):
        super().__init__(parameters, mesh, parser)
        p = self.parameters
        # the "dtype" parameter overrides the keyword (porotpu parity)
        dtype = _resolve_dtype(p.get("dtype"), dtype)
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Poromechanics: device {!r} asked for, but torch sees no CUDA card; "
                "pass device='cpu' to run the plain versions on the host".format(str(device))
            )
        self.markers = markers

        Vs = FunctionSpace(mesh, p.get("fe degree solid", 2), vector=True)
        Vf = FunctionSpace(mesh, p.get("fe degree fluid", 2), vector=True)
        Qp = FunctionSpace(mesh, p.get("fe degree pressure", 1), vector=False)
        self.W = MixedSpace({"s": Vs, "f": Vf, "p": Qp})
        self.V = self.W

        self.pc_type = p["pc type"]
        if self.pc_type not in PC_TYPES:
            raise SystemExit(
                "pc type must be one of lu, undrained, diagonal, "
                "diagonal 3-way, diagonal 3-way-II, undrained 3-way."
            )
        self.three_way = "3-way" in self.pc_type and self.pc_type != "diagonal 3-way-II"
        self.two_way = not self.three_way

        log(
            "---- Problem dofs={}, h={}, solving on {}".format(
                self.W.num_dofs, mesh.hmin(), self.device
            )
        )
        self.assembler = PoromechanicsAssembler(p, self.W, self.three_way)

        ns, nf, npp = self.W.get_dimensions()
        self.ns, self.nf, self.npp = ns, nf, npp

        # --- padded-field layout (porotpu/models/poromechanics.py:112-135)
        m = int(p.get("pad multiple", 1))
        dim = mesh.dim
        L = (m * dim) // math.gcd(m, dim)  # pad to lcm so node blocks survive

        def _pad(s, unit):
            return ((s + unit - 1) // unit) * unit

        self.ns_p = _pad(ns, L)
        self.nf_p = _pad(nf, L)
        self.np_p = _pad(npp, m)
        self.n_pad = self.ns_p + self.nf_p + self.np_p
        self.padded_sizes = (self.ns_p, self.nf_p, self.np_p)
        self.pad_index = np.concatenate(
            [
                np.arange(ns),
                np.arange(nf) + self.ns_p,
                np.arange(npp) + self.ns_p + self.nf_p,
            ]
        )

        # history fields (device, padded), reference lib/Poromechanics.py:33-35
        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=self.device)

        self.us_nm1 = zeros(self.ns_p)
        self.us_nm2 = zeros(self.ns_p)
        self.uf_nm1 = zeros(self.nf_p)
        self.p_nm1 = zeros(self.np_p)
        self.sol = zeros(self.n_pad)

        self.row_mesh = None  # the row mesh of a sharded solve
        self.first_timestep = True
        self.bcs = []
        self.bcs_diff = []
        self.bcs_sub_pressure = np.zeros(0, dtype=np.int64)
        self.iteration_log = []
        self.t_setup = 0.0
        self.t_solve_total = 0.0
        self.t_cache_save = 0.0  # the cache's pickle, on the setup's thread
        self.cache_writer = None  # the thread writing it to disk
        self.pc_applies = 0

    # ------------------------------------------------------------------
    def set_bcs(self, bcs, bcs_diff):
        """Set Dirichlet BCs (assumed constant in time)."""
        self.bcs = list(bcs)
        self.bcs_diff = list(bcs_diff)
        subs = [bc.local_dofs for bc in self.bcs_diff if bc.field == "p"]
        self.bcs_sub_pressure = (
            np.unique(np.concatenate(subs)) if subs else np.zeros(0, np.int64)
        )

    # ------------------------------------------------------------------
    def _pad_field_square(self, M: sp.csr_matrix, size_p: int) -> sp.csr_matrix:
        """Pad a single-field square operator with identity rows."""
        n = M.shape[0]
        if n == size_p:
            return M.tocsr()
        coo = M.tocoo()
        pads = np.arange(n, size_p)
        rows = np.concatenate([coo.row, pads])
        cols = np.concatenate([coo.col, pads])
        data = np.concatenate([coo.data, np.ones(pads.size)])
        return sp.csr_matrix((data, (rows, cols)), shape=(size_p, size_p))

    def _pad_rect(self, M: sp.csr_matrix, rp: int, cp: int) -> sp.csr_matrix:
        M = M.tocsr(copy=True)
        M.resize((rp, cp))
        return M

    def _bc_applied_blocks(self):
        """Per-block BC row surgery + padding.  Copy of
        porotpu/models/poromechanics.py:246-312.

        Returns (A_blocks, P_blocks, P_diff_pp, (bc_dofs, bc_vals)): dicts
        keyed (row_field, col_field) of padded CSRs; the 3-way PC's padded
        pressure-diffusion block, its rows zeroed with a unit diagonal at
        the pressure dofs of ``bcs`` and ``bcs_diff`` (None for 2-way); bc
        data in padded numbering.
        """
        if self.assembler.A_blocks is None:
            self.assembler.assemble()
        W = self.W
        order = list(FIELDS)
        sizes = {k: W.field(k).size for k in order}
        psizes = dict(zip(order, self.padded_sizes))
        offs, off = {}, 0
        for k in order:
            offs[k] = off
            off += sizes[k]

        bc_dofs, bc_vals = bc_dofs_values(self.bcs)
        bc_loc = {
            k: bc_dofs[(bc_dofs >= offs[k]) & (bc_dofs < offs[k] + sizes[k])]
            - offs[k]
            for k in order
        }

        def bc_pad(blocks):
            missing = [k for k in order if (k, k) not in blocks]
            if missing:
                raise ValueError(f"missing diagonal blocks: {missing}")
            out = {}
            for (r, c), M in blocks.items():
                M = zero_rows(M.tocsr(), bc_loc[r], unit_diag=(r == c))
                if r == c:
                    M = self._pad_field_square(M, psizes[r])
                else:
                    M = self._pad_rect(M, psizes[r], psizes[c])
                out[(r, c)] = M
            return out

        Ab = bc_pad(self.assembler.A_blocks)
        Pb = bc_pad(self.assembler.P_blocks)

        Pd = self.assembler.P_diff_pp
        if self.three_way and Pd is not None:
            p_rows = [bc.local_dofs for bc in self.bcs + self.bcs_diff if bc.field == "p"]
            rows = np.unique(np.concatenate(p_rows)) if p_rows else np.zeros(0, np.int64)
            Pd = self._pad_field_square(
                zero_rows(Pd.tocsr(), rows, unit_diag=True), self.np_p
            )
        return Ab, Pb, Pd, (self.pad_index[bc_dofs], bc_vals)

    def _inner_cfg(self, block: str) -> InnerConfig:
        """Inner solver config for one block, with options-DB override
        (porotpu/models/poromechanics.py:314-359)."""
        p = self.parameters
        odb = p.get("options db")
        cfg = odb.inner_config(block) if odb is not None else None
        if cfg is None:
            cfg = InnerConfig.from_reference_options(
                p.get("inner ksp type", "gmres"),
                p.get("inner pc type", "hypre"),
                int(p.get("inner maxiter", 10)),
            )
        ii = p.get("inner iters")
        if ii is not None and cfg.method in ITERATED:
            cfg.iters = int(ii)
            if cfg.method == "amg":
                cfg.sweeps = int(ii)
        for key, attr, cast in (
            ("amg coarse size", "amg_coarse_size", int),
            ("amg theta", "amg_theta", float),
            ("amg presmooth", "amg_presmooth", int),
            ("amg postsmooth", "amg_postsmooth", int),
            ("amg box factor", "amg_box_factor", float),
            ("amg smooth degree", "amg_smooth_degree", int),
            ("amg cheb lower", "amg_cheb_lower", float),
            ("amg p drop", "amg_p_drop", float),
        ):
            v = p.get(key)
            if v is not None:
                setattr(cfg, attr, cast(v))
        return cfg

    def _padded_coords(self, space, n_pad_nodes):
        """Node coordinates extended with pad nodes beyond the domain, one
        lattice step apart (porotpu/models/poromechanics.py:361)."""
        coords = space.node_coords
        if n_pad_nodes == 0:
            return coords
        h = self.mesh.hmin() / max(space.degree, 1)
        pad = np.tile(coords.max(axis=0), (n_pad_nodes, 1))
        pad[:, 0] += h * (np.arange(n_pad_nodes) + 2)
        return np.vstack([coords, pad])

    def _rigid_modes_padded(self, space, n_field, n_field_p, dof_offset, bc_dofs):
        """Rigid-body near-nullspace of a padded vector field, BC rows zeroed
        (porotpu/models/poromechanics.py:374)."""
        dim = self.mesh.dim
        pad_nodes = (n_field_p - n_field) // dim
        B = rigid_body_modes(self._padded_coords(space, pad_nodes))
        f_bc = bc_dofs[(bc_dofs >= dof_offset) & (bc_dofs < dof_offset + n_field)]
        mask = np.ones(n_field_p, bool)
        mask[f_bc - dof_offset] = False
        return B * mask[:, None]

    # ------------------------------------------------------------------
    def create_solver(self, mesh=None):
        """Build the operators and the block PC on the host, save them to
        ``solver cache path`` when it is set, then move the whole solver
        state to ``self.device`` (porotpu/models/poromechanics.py:397-433).
        With a row ``mesh`` (kept in ``row_mesh`` for later steps) the state
        is sharded first and moves to the rank's device."""
        if mesh is not None:
            self.row_mesh = mesh
        t0 = _time.perf_counter()
        self._build_operators()
        cpath = self.parameters.get("solver cache path")
        if cpath:
            # pickled here, on the host: the move below swaps the buffers of
            # these same modules in place
            t1 = _time.perf_counter()
            self.cache_writer = self.save_solver_cache(cpath)
            self.t_cache_save = _time.perf_counter() - t1
        self._shard()
        self._to_device()
        self._finalize_solver()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_setup = _time.perf_counter() - t0
        log("---- [Solver] Solver created in {}s".format(self.t_setup))

    @property
    def local_sizes(self):
        """The rank's field sizes: the padded sizes, divided by the world
        size on a mesh."""
        if self.row_mesh is None:
            return self.padded_sizes
        return tuple(self.row_mesh.slab_len(n, "padded field size") for n in self.padded_sizes)

    def _shard(self):
        """Keep this rank's slabs of the host-built solver state (no mesh:
        nothing), and the history vectors at the local sizes on the rank's
        device."""
        mesh = self.row_mesh
        if mesh is None:
            return
        from ..parallel import sharding

        memo = {}
        self.A_dev = sharding.shard_operator(self.A_dev, mesh, memo)
        pc = self.pc
        self.pc = sharding.shard_operator(pc, mesh, memo)
        if self.H_dev is not None:
            self.H_dev = sharding.shard_operator(self.H_dev, mesh, memo)
        keep, self.bc_dofs = sharding.local_index(mesh, self.padded_sizes, self.bc_dofs)
        self.bc_vals = self.bc_vals[keep]
        self.device = mesh.device
        ns, nf, npp = self.local_sizes
        z = lambda n: torch.zeros(n, dtype=self.dtype, device=self.device)  # noqa: E731
        self.us_nm1, self.us_nm2, self.uf_nm1, self.p_nm1 = z(ns), z(ns), z(nf), z(npp)
        self.sol = z(ns + nf + npp)

    def _to_device(self):
        self.A_dev = self.A_dev.to(self.device)
        self.pc = self.pc.to(self.device)
        if self.H_dev is not None:
            self.H_dev = self.H_dev.to(self.device)
        self.bc_dofs = self.bc_dofs.to(self.device)
        self.bc_vals = self.bc_vals.to(self.device)

    def solver_state(self):
        """The solver state the cache holds (porotpu/models/poromechanics.py:712-720)."""
        return {
            "A_dev": self.A_dev,
            "pc": self.pc,
            "H_dev": self.H_dev,
            "bc_dofs": self.bc_dofs,
            "bc_vals": self.bc_vals,
        }

    def save_solver_cache(self, path: str):
        """Pickle the solver state now and write it to ``path`` in the
        background; returns the writer thread.  Call it while the state is
        on the host, as ``create_solver`` does."""
        from ..utils import cache

        return cache.save_async(path, self.solver_state())

    def try_load_solver_cache(self, path: str) -> bool:
        """Restore the solver state from a cache file, skipping all host
        setup, and move it to ``self.device``; returns True on success.
        Any failure is a miss (porotpu/models/poromechanics.py:727-758)."""
        from ..utils import cache

        t0 = _time.perf_counter()
        try:
            st = cache.load(path)
            if st is None:
                return False
            self.A_dev = st["A_dev"]
            self.pc = st["pc"]
            # the cache holds the PC built with the "inner iters" of its
            # save; apply the current setting
            ii = self.parameters.get("inner iters")
            if ii is not None:
                remap_inner_iters(self.pc, int(ii))
            self.H_dev = st["H_dev"]
            self.bc_dofs = st["bc_dofs"]
            self.bc_vals = st["bc_vals"]
            # the term spec derives from the parameters only (no assembly)
            self._hist_terms = (
                self.assembler.history_term_spec() if self.H_dev is not None else None
            )
            self._shard()
            self._to_device()
            self._finalize_solver()
        except Exception as e:  # a stale or corrupt cache must never crash a run
            log(f"---- [Cache] ignoring unusable solver cache {path}: {e}")
            return False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.first_timestep = False
        self.t_setup = _time.perf_counter() - t0
        return True

    def _build_operators(self):
        """porotpu/models/poromechanics.py:453-709."""
        W = self.W
        ns_p, nf_p, np_p = self.padded_sizes
        dtype = self.dtype
        p = self.parameters
        # "pc dtype" builds the whole PC payload (inner solvers, couplings,
        # dense factors) at a lower precision than the outer solve; the
        # apply is then wrapped in CastPC (porotpu/models/poromechanics.py:457-462)
        pc_dtype = _resolve_dtype(p.get("pc dtype"), dtype)
        if self.assembler.rhs_mode not in ("loads-only", "full-residual"):
            raise ValueError(f"unknown rhs mode {self.assembler.rhs_mode!r}")
        dim = self.mesh.dim

        Ab, Pb, Pd_pp, (bc_dofs, bc_vals) = self._bc_applied_blocks()
        self.bc_dofs = torch.as_tensor(bc_dofs, dtype=torch.int64)
        self.bc_vals = torch.as_tensor(bc_vals, dtype=dtype)
        psz = {"s": ns_p, "f": nf_p, "p": np_p}

        def _pget(r, c):
            return Pb.get((r, c), sp.csr_matrix((psz[r], psz[c])))

        # pressure (P1) dofs embed into the P2 vector lattices, making the
        # coupling blocks banded
        emb_ps = vertex_embedding(W.space("p"), W.space("s"), np_p, ns_p)
        emb_pf = vertex_embedding(W.space("p"), W.space("f"), np_p, nf_p)
        embs = {
            ("s", "p"): dict(col_emb=emb_ps),
            ("f", "p"): dict(col_emb=emb_pf),
            ("p", "s"): dict(row_emb=emb_ps),
            ("p", "f"): dict(row_emb=emb_pf),
        }
        a_blocks = {}
        for (rf, cf), blk in sorted(Ab.items()):
            blk = blk.tocsr()
            blk.eliminate_zeros()
            if blk.nnz:
                a_blocks[(rf, cf)] = device_matrix(blk, dtype, **embs.get((rf, cf), {}))
        self.A_dev = FieldMatrix(a_blocks, psz)

        B_s = self._rigid_modes_padded(W.space("s"), self.ns, ns_p, 0, bc_dofs)
        B_f = self._rigid_modes_padded(W.space("f"), self.nf, nf_p, ns_p, bc_dofs)
        xyz_s = self._padded_coords(W.space("s"), (ns_p - self.ns) // dim)
        xyz_f = self._padded_coords(W.space("f"), (nf_p - self.nf) // dim)
        xyz_p = self._padded_coords(W.space("p"), np_p - self.npp)

        solve_s = build_inner_solver(
            _pget("s", "s"),
            self._inner_cfg("s"),
            dofs_per_node=dim,
            near_nullspace=B_s,
            coords=xyz_s,
            dtype=pc_dtype,
        )

        if self.three_way:
            self.pc = self._three_way_pc(
                solve_s, _pget, Pd_pp, B_f, xyz_f, xyz_p, emb_pf, emb_ps, pc_dtype
            )
        else:
            cfg_fp = self._inner_cfg("fp")
            fs_args = (_pget, bc_dofs, B_f, xyz_f, xyz_p, emb_pf, pc_dtype)
            if cfg_fp.method == "lu":
                solve_fp = self._exact_fp_solve(cfg_fp, *fs_args)
            else:
                solve_fp = self._schur_fp_solve(
                    self._inner_cfg("fp_fieldsplit_0"), self._inner_cfg("fp_fieldsplit_1"),
                    *fs_args,
                )
            self.pc = BlockPreconditioner(
                ns_p,
                nf_p,
                np_p,
                solve_s,
                solve_fp,
                Pfs=device_matrix(_pget("f", "s"), pc_dtype),
                Pps=device_matrix(_pget("p", "s"), pc_dtype, row_emb=emb_ps),
            )
        if pc_dtype != dtype:
            self.pc = CastPC(self.pc, dtype, pc_dtype)
        self.H_dev, self._hist_terms = self._history_operators(emb_ps)

    def _three_way_pc(self, solve_s, _pget, Pd_pp, B_f, xyz_f, xyz_p, emb_pf, emb_ps,
                      pc_dtype):
        """The 3-way block PC (porotpu/models/poromechanics.py:646-680): the
        fluid, pressure and pressure-diffusion inner solves, the couplings
        Mf_p, Ms_f and Ms_p, and the diffusion RHS mask, zero at the
        pressure dofs of ``bcs_diff``."""
        ns_p, nf_p, np_p = self.padded_sizes
        solve_f = build_inner_solver(
            _pget("f", "f"),
            self._inner_cfg("f"),
            dofs_per_node=self.mesh.dim,
            near_nullspace=B_f,
            coords=xyz_f,
            dtype=pc_dtype,
        )
        solve_p = build_inner_solver(
            _pget("p", "p"), self._inner_cfg("p"), coords=xyz_p, dtype=pc_dtype
        )
        solve_diff = build_inner_solver(
            Pd_pp, self._inner_cfg("diff"), coords=xyz_p, dtype=pc_dtype
        )
        mask = np.ones(np_p)
        mask[self.bcs_sub_pressure] = 0.0
        p = self.parameters
        return BlockPreconditioner(
            ns_p,
            nf_p,
            np_p,
            solve_s,
            three_way=True,
            solve_f=solve_f,
            solve_p=solve_p,
            solve_diff=solve_diff,
            Pfp=device_matrix(_pget("f", "p"), pc_dtype, col_emb=emb_pf),
            Psf=device_matrix(_pget("s", "f"), pc_dtype),
            Psp=device_matrix(_pget("s", "p"), pc_dtype, col_emb=emb_ps),
            diff_rhs_mask=torch.as_tensor(mask, dtype=pc_dtype),
            w1=float(p.get("w1", 1.0)),
            w2=float(p.get("w2", 0.1)),
        )

    def _exact_fp_solve(self, cfg_fp, _pget, bc_dofs, B_f, xyz_f, xyz_p, emb_pf, pc_dtype):
        """The exact operating point (porotpu/models/poromechanics.py:563-616):
        one dense LU of the whole fp block up to ``lu_max_size``
        (petsc-options-exact); above it, or forced by ``-fp_lu_max_size 0``
        (petsc-options-exact-iterative), the quasi-exact ``fgmres+fs`` solve:
        ``lu_fallback_iters`` FGMRES iterations on the saddle fp operator,
        preconditioned by the Schur fieldsplit with 20 cg+amg fluid
        iterations and the Schur part by ``lu`` (dense up to its own cap)."""
        _, nf_p, np_p = self.padded_sizes
        if nf_p + np_p <= cfg_fp.lu_max_size:
            P_fpfp = sp.bmat(
                [[_pget("f", "f"), _pget("f", "p")], [_pget("p", "f"), _pget("p", "p")]],
                format="csr",
            )
            return build_inner_solver(P_fpfp, cfg_fp, dtype=pc_dtype)
        fs = self._schur_fp_solve(
            InnerConfig(method="cg+amg", iters=20), InnerConfig(method="lu"),
            _pget, bc_dofs, B_f, xyz_f, xyz_p, emb_pf, pc_dtype,
        )
        fp_op = FieldMatrix(
            {
                ("f", "f"): device_matrix(_pget("f", "f"), pc_dtype),
                ("f", "p"): device_matrix(_pget("f", "p"), pc_dtype, col_emb=emb_pf),
                ("p", "f"): device_matrix(_pget("p", "f"), pc_dtype, row_emb=emb_pf),
                ("p", "p"): device_matrix(_pget("p", "p"), pc_dtype),
            },
            {"f": nf_p, "p": np_p},
        )
        return InnerSolver(
            "fgmres+fs", {"A": fp_op, "fs": fs}, iters=int(cfg_fp.lu_fallback_iters)
        )

    def _schur_fp_solve(self, cfg_f, cfg_S, _pget, bc_dofs, B_f, xyz_f, xyz_p, emb_pf,
                        pc_dtype):
        """The lower Schur fieldsplit with the dcc or selfp Schur
        (porotpu/models/poromechanics.py:530-561, 574-633), its fluid solved
        by ``cfg_f`` and its Schur part by ``cfg_S``: the inexact operating
        point's fp solve, and the preconditioner of the quasi-exact one."""
        ns_p, nf_p, np_p = self.padded_sizes
        dim = self.mesh.dim
        p = self.parameters
        schur_kind = p.get("schur precondition", "dcc")
        odb = p.get("options db")
        if odb is not None:
            v = odb.get("fp_pc_fieldsplit_schur_precondition")
            if v is not None:
                schur_kind = v
        # dcc diagonals (porotpu/models/poromechanics.py:543-561)
        asm = self.assembler
        gamma = asm.rhof * asm.idt * asm.phi0 + (1.0 + asm.betaf) * asm.phi0**2 * asm.ikf
        mdiag = np.ones(nf_p)
        Mvf = asm.pr.Mv_f
        mdiag[: Mvf.shape[0]] = gamma * np.asarray(Mvf.diagonal()).ravel()
        visc = np.zeros(np_p)
        mp_lump = np.asarray(asm.pr.Mp.sum(axis=1)).ravel()
        mp_lump[mp_lump == 0] = 1.0
        visc[: mp_lump.size] = (2.0 * asm.mu_f / asm.phi0) / mp_lump
        p_bc = bc_dofs[bc_dofs >= ns_p + nf_p] - (ns_p + nf_p)
        visc[p_bc] = 0.0  # Dirichlet pressure rows stay identity

        return build_schur_fieldsplit(
            _pget("f", "f"),
            _pget("f", "p"),
            _pget("p", "f"),
            _pget("p", "p"),
            cfg_f,
            cfg_S,
            dofs_per_node_f=dim,
            near_nullspace_f=B_f,
            coords_f=xyz_f,
            coords_p=xyz_p,
            row_emb_pf=emb_pf,
            dtype=pc_dtype,
            schur_kind=schur_kind,
            mass_drag_diag=mdiag,
            visc_diag=visc,
        )

    def _history_operators(self, emb_ps):
        """The full-residual RHS's device operators and term spec
        (porotpu/models/poromechanics.py:690-709): the shared primitives
        (Mv_s, D_s, Mp; Mv_f and Mfs when the degrees differ) padded to the
        field sizes, D_s under the P1 -> P2 row embedding.  (None, None)
        in loads-only mode."""
        if self.assembler.rhs_mode != "full-residual":
            return None, None
        ns_p, nf_p, np_p = self.padded_sizes
        shapes = {
            "Mv_s": (ns_p, ns_p),
            "Mv_f": (nf_p, nf_p),
            "Mfs": (nf_p, ns_p),
            "D_s": (np_p, ns_p),
            "Mp": (np_p, np_p),
        }
        h_embs = {"D_s": dict(row_emb=emb_ps)}
        H = nn.ModuleDict({
            k: device_matrix(self._pad_rect(v, *shapes[k]), self.dtype, **h_embs.get(k, {}))
            for k, v in self.assembler.history_ops().items()
        })
        return H, self.assembler.history_term_spec()

    # ------------------------------------------------------------------
    def _finalize_solver(self):
        """Solver settings (porotpu/models/poromechanics.py:760-870).

        Unlike porotpu (ADVICE r5, poromechanics.py:799), the options-DB
        ``global_`` overrides are applied BEFORE ``solver chunk`` splits
        maxiter, so an overridden maxiter is what gets chunked, and the
        chunk rule is decided on the solver type they leave: ``aar`` is
        never chunked, ``cg`` runs its chunks as warm restarts, and a
        gmres/fgmres chunk must be a multiple of the restart length.
        Every options file sets ``-global_ksp_type gmres``, which shadows
        ``solver type`` as in porotpu (:790-795).
        """
        p = self.parameters
        if bool(p.get("inner monitor", False)):
            # the reference's per-field inner KSP monitors
            # (lib/Preconditioner.py:94-100, lib/Parser.py:27-28)
            set_inner_monitor(self.pc, True)
        solver_type = p.get("solver type", "gmres")
        rtol = float(p.get("solver rtol", 1e-6))
        atol = float(p.get("solver atol", 1e-8))
        maxiter = int(p.get("solver maxiter", 500))
        # global_ prefix overrides (reference lib/Solver.py:101)
        odb = p.get("options db")
        if odb is not None:
            g = odb.prefix_items("global")
            if g.get("ksp_type"):
                solver_type = g["ksp_type"]
            if g.get("ksp_rtol"):
                rtol = float(g["ksp_rtol"])
            if g.get("ksp_atol"):
                atol = float(g["ksp_atol"])
            if g.get("ksp_max_it"):
                maxiter = int(g["ksp_max_it"])
        if solver_type not in ("aar", "cg", "gmres", "fgmres"):
            raise ValueError(
                f"unknown solver type {solver_type!r}; types: aar, cg, gmres, fgmres"
            )
        mesh = self.row_mesh
        accel = int(p.get("inner accel order", 0))
        restart = int(p.get("gmres restart", min(50, maxiter)))
        # "solver chunk": ceil(maxiter/chunk) warm-started calls of a
        # chunk-maxiter solve — identical to one long gmres solve only when
        # the chunk is a multiple of the restart length
        chunk = int(p.get("solver chunk", 0))
        self._solve_chunks = 1
        if chunk > 0 and solver_type != "aar":
            if solver_type != "cg" and chunk % min(restart, chunk) != 0:
                raise ValueError(
                    f"solver chunk {chunk} must be a multiple of the gmres restart {restart}"
                )
            self._solve_chunks = -(-maxiter // chunk)
            maxiter = chunk
        self._maxiter = maxiter
        use_fieldwise = bool(p.get("fieldwise convergence", True))
        sizes = self.local_sizes
        divtol = float(p.get("solver divtol", 1e20))

        @torch.inference_mode()
        def _solve(b, x0):
            if solver_type == "aar":
                return aar(
                    self.A_dev.matvec,
                    b,
                    M=self.pc,
                    x0=x0,
                    order=int(p.get("AAR order", 10)),
                    p=int(p.get("AAR p", 5)),
                    omega=float(p.get("AAR omega", 1.0)),
                    beta=float(p.get("AAR beta", 1.0)),
                    rtol=rtol,
                    atol=atol,
                    maxiter=maxiter,
                    pc_accel_order=accel,
                    divtol=divtol,
                    monitor=bool(p.get("solver monitor", False)),
                    mesh=mesh,
                )
            fw = FieldwiseTest.from_sizes(sizes, b, mesh) if use_fieldwise else None
            if solver_type == "cg":
                return cg(
                    self.A_dev.matvec, b, x0=x0, M=self.pc, rtol=rtol, atol=atol,
                    maxiter=maxiter, fieldwise=fw, divtol=divtol, mesh=mesh,
                )
            # gmres and fgmres both run flexible GMRES, as porotpu's: the
            # inner solves make the PC non-constant.  With "inner accel
            # order" the mixed PC output adds only stored directions, so
            # the trace is the one without it (porotpu :845-856)
            return fgmres(
                self.A_dev.matvec,
                b,
                x0=x0,
                M=self.pc,
                restart=restart,
                rtol=rtol,
                atol=atol,
                maxiter=maxiter,
                fieldwise=fw,
                divtol=divtol,
                pc_accel_order=accel,
                mesh=mesh,
            )

        self._solve = _solve

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _rhs_hist(self):
        """The history part of the full-residual RHS, sum of c * H[op] @ vec
        in the order of the term spec (porotpu/models/poromechanics.py:876-887)."""
        vecs = {"us1": self.us_nm1, "us2": self.us_nm2, "uf1": self.uf_nm1, "p1": self.p_nm1}
        parts = {}
        for (field, hv), (op, c) in self._hist_terms.items():
            contrib = c * self.H_dev[op].matvec(vecs[hv])
            parts[field] = parts[field] + contrib if field in parts else contrib
        return torch.cat([parts["s"], parts["f"], parts["p"]])

    def get_rhs(self, t):
        """Load vector at time t, plus the history terms in full-residual
        mode, with the Dirichlet values set (porotpu :890-901)."""
        loads = self.assembler.get_load_vector(t)
        b_np = np.zeros(self.n_pad)
        b_np[self.pad_index] = loads
        b = torch.as_tensor(b_np, dtype=self.dtype)
        if self.row_mesh is not None:
            from ..parallel import sharding

            b = sharding.shard_vector(b, self.row_mesh, self.padded_sizes)
        b = trace.host_copy(b, self.device)
        if self.H_dev is not None:
            b = b + self._rhs_hist()
        b[self.bc_dofs] = self.bc_vals
        return b

    @trace.spanned(trace.STEP)
    def solve_time_step(self, t):
        if self.first_timestep:
            self.create_solver()
            self.first_timestep = False

        b = self.get_rhs(t)
        t0 = _time.perf_counter()
        res = self._solve(b, torch.zeros_like(b))
        total_its = res.iters
        for _ in range(self._solve_chunks - 1):
            if res.converged or res.diverged:
                break
            res = self._solve(b, res.x)
            total_its += res.iters
        trace.synchronize(self.device)
        self.t_solve_total += _time.perf_counter() - t0

        self.sol = res.x
        self.pc_applies += total_its
        ns_p, nf_p, _ = self.local_sizes
        self.us_nm2 = self.us_nm1
        self.us_nm1 = res.x[:ns_p]
        self.uf_nm1 = res.x[ns_p : ns_p + nf_p]
        self.p_nm1 = res.x[ns_p + nf_p :]
        self.iteration_log.append(total_its)
        self.last_result = res
        self.last_rhs = b  # the right-hand side of this step (history before rotation)
        if self.parameters.get("solver monitor", False):
            hist = res.history[~np.isnan(res.history)]
            for k, r in enumerate(hist):
                log("KSP it {}:   {:.5e}".format(k, float(r)))
            log(
                "---- [Solver] {}".format(
                    "Converged"
                    if res.converged
                    else ("DIVERGED (residual exceeded divtol)" if res.diverged else "NOT converged")
                )
            )
        return total_its

    def solution_fields(self):
        """Vertex values of the three fields (mesh-vertex order) for export
        (porotpu/models/poromechanics.py:953-971): the nodes are numbered
        lattice-lexicographically, so each space's ``vert_node`` map picks
        the vertex values."""
        dim = self.mesh.dim
        vs = self.W.space("s").vert_node
        vf = self.W.space("f").vert_node
        vp = self.W.space("p").vert_node
        whole = (lambda v: v) if self.row_mesh is None else self.row_mesh.all_gather  # noqa: E731
        us = whole(self.us_nm1).cpu().numpy()[: self.ns].reshape(-1, dim)[vs]
        uf = whole(self.uf_nm1).cpu().numpy()[: self.nf].reshape(-1, dim)[vf]
        p = whole(self.p_nm1).cpu().numpy()[: self.npp][vp]
        return {
            "displacement": us,
            "fluid velocity": uf,
            "pressure": p,
        }

    def unpadded_solution(self):
        """Solution vector in the original (unpadded) dof numbering; on a
        mesh gathered from the ranks' slabs."""
        sol = self.sol
        if self.row_mesh is not None:
            from ..parallel import sharding

            sol = sharding.gather_vector(sol, self.row_mesh, self.local_sizes)
        return sol.cpu().numpy()[self.pad_index]

    # ------------------------------------------------------------------
    def print_timings(self):
        """The solver's total time, then what the spans (``utils.trace``)
        recorded inside the solve, when tracing was on: the block PC's
        applies and its stages in the format of the reference
        (lib/Preconditioner.py:252-260; 3-way: Pressure is ``pc.p`` and
        ``pc.diff``), the AMG hierarchies' host setup with its sparse
        products and how many of them ran in row blocks on how many
        threads, and the host syncs of the steps.  The PC's seconds are
        the host's, spent issuing each stage; on the card the device runs
        behind them.  Then, from the always-on counters, the banded
        products' stored diagonal values, the share of them that are
        structural zeros and K1's share on its scalar path.  With nothing
        recorded and no banded product, the Solver line alone."""
        log("\n===== Timing Solver: {:.3f}s".format(self.t_solve_total))
        tot = trace.totals()
        app = tot.get(trace.PC_APPLY)
        if app is not None:
            if self.three_way:
                stages = (("Solid", "pc.s"), ("Fluid", "pc.f"), ("Pressure", "pc.p", "pc.diff"))
            else:
                stages = (("Solid", "pc.s"), ("Fluid-pressure", "pc.fp"))
            log("\n===== Timing preconditioner: {:.3f}s ({} applications; host seconds issuing "
                "each stage inside the solve)".format(app.seconds, app.count))
            log("\n".join("\t{} solver: {:.3f}s".format(
                name, sum(tot[k].seconds for k in spans if k in tot)) for name, *spans in stages))
        amg = tot.get(trace.AMG_SETUP)
        if amg is not None:
            gal = tot.get(trace.GALERKIN, trace.Total())
            log("\n===== Timing AMG setup: {:.3f}s ({} hierarchies); Galerkin {:.3f}s in {} "
                "products, {} in row blocks on {} threads".format(
                    amg.seconds, amg.count, gal.seconds, gal.count,
                    trace.counts().get(trace.ROW_BLOCKED, 0), host_threads()))
        step = tot.get(trace.STEP)
        if step is not None:
            log("\n===== Host syncs: {} in {} steps".format(trace.host_syncs(), step.count))
        band = trace.banded_totals()
        if band.stored:
            log("\n===== Banded products: {} diagonal values stored, {:.2f}% structural zeros; "
                "K1 {:.2f}% of its values on the scalar path".format(
                    band.stored, band.fill, band.k1_scalar_share or 0.0))

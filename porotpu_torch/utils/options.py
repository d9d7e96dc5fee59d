# Copy of porotpu/utils/options.py; it builds the port's InnerConfig.
"""Prefix-keyed solver options database (PETSc options DB equivalent).

The reference configures every inner solver through the global PETSc
options database with prefixes ``global_, s_, f_, p_, fp_, diff_,
fp_fieldsplit_0_, fp_fieldsplit_1_`` loaded from an options file
(lib/Parser.py:61-73; petsc-options-exact / petsc-options-inexact).

This class parses the *same file format* (lines ``-key value`` with
``#`` comments) and maps the recognized key families onto InnerConfig
objects.  Unknown keys are stored but ignored (PETSc behavior).
"""

from __future__ import annotations

from ..precond.inner import InnerConfig


class OptionsDB:
    def __init__(self, entries: dict | None = None):
        self.entries = dict(entries or {})

    @classmethod
    def from_file(cls, path: str) -> "OptionsDB":
        """Parse a petsc-options-style file (lib/Parser.py:61-73 semantics)."""
        entries = {}
        with open(path) as fh:
            for _line in fh:
                line = _line.strip()
                if not line or line.startswith("#"):
                    continue
                split = line.split(" ")
                key = split[0].lstrip("-")
                val = split[-1] if len(split) > 1 else None
                entries[key] = val
        return cls(entries)

    def set(self, key: str, value=None):
        self.entries[key.lstrip("-")] = value

    def get(self, key: str, default=None):
        return self.entries.get(key, default)

    def prefix_items(self, prefix: str) -> dict:
        pre = prefix if prefix.endswith("_") else prefix + "_"
        return {
            k[len(pre) :]: v for k, v in self.entries.items() if k.startswith(pre)
        }

    # ------------------------------------------------------------------
    def inner_config(self, prefix: str) -> InnerConfig | None:
        """Build an InnerConfig from ``{prefix}_ksp_type``/``{prefix}_pc_type``.

        Returns None when the DB holds nothing for that prefix, so callers
        fall back to the parameter-dict defaults (the reference's
        setFromOptions override semantics).
        """
        items = self.prefix_items(prefix)
        if not items:
            return None
        # porotpu-native direct keys take precedence
        if "method" in items:
            cfg = InnerConfig(method=items["method"])
            if "iters" in items:
                cfg.iters = int(items["iters"])
            if "sweeps" in items:
                cfg.sweeps = int(items["sweeps"])
            return cfg

        ksp = (items.get("ksp_type") or "").lower()
        pc = (items.get("pc_type") or "").lower()
        max_it = items.get("ksp_max_it")
        max_it = int(max_it) if max_it is not None else None

        if pc in ("lu", "cholesky") or (
            pc == "" and items.get("pc_factor_mat_solver_type")
        ):
            cfg = InnerConfig(method="lu")
            # quasi-exact operating point (petsc-options-exact-iterative):
            # -X_lu_max_size 0 forces the tight-iterative MUMPS substitute
            # (cg+amg at lu_fallback_iters) even where dense LU would fit,
            # so the substitution can be validated against true dense-LU
            # outer counts on the overlapping grid cells (ANALYSIS.md §6)
            if "lu_max_size" in items:
                cfg.lu_max_size = int(items["lu_max_size"])
            if "lu_fallback_iters" in items:
                cfg.lu_fallback_iters = int(items["lu_fallback_iters"])
            return cfg
        if pc in ("hypre", "gamg", "ml", "amg"):
            sweeps = items.get("pc_hypre_boomeramg_grid_sweeps_all")
            cfg_kwargs = {}
            if sweeps is not None:
                cfg_kwargs["amg_presmooth"] = cfg_kwargs["amg_postsmooth"] = int(
                    sweeps
                )
            # porotpu-native per-prefix AMG knobs (the -pc_hypre_boomeramg_*
            # analogues for the SA hierarchy)
            for key, attr, cast in (
                ("pc_amg_box_factor", "amg_box_factor", float),
                ("pc_amg_smooth_degree", "amg_smooth_degree", int),
                ("pc_amg_cheb_lower", "amg_cheb_lower", float),
                ("pc_amg_theta", "amg_theta", float),
                ("pc_amg_coarse_size", "amg_coarse_size", int),
            ):
                v = items.get(key)
                if v is not None:
                    cfg_kwargs[attr] = cast(v)
            if ksp in ("preonly", ""):
                return InnerConfig(method="amg", **cfg_kwargs)
            return InnerConfig(
                method="cg+amg", iters=max_it or 5, **cfg_kwargs
            )
        if pc in ("jacobi", "bjacobi", "none", "sor", "ilu", "asm"):
            # no ILU/SOR/ASM on TPU: substitute cg+jacobi (documented)
            if ksp in ("preonly", ""):
                return InnerConfig(method="jacobi")
            return InnerConfig(method="cg", iters=max_it or 10)
        if pc == "fieldsplit":
            # handled structurally by the model layer (Schur fieldsplit);
            # signal "not a leaf solver" by returning None here
            return None
        if ksp == "chebyshev":
            return InnerConfig(method="chebyshev", iters=max_it or 10)
        return None

# Copy of porotpu/utils/parser.py, with one more flag, --device.
"""CLI parser with the reference's flag surface (lib/Parser.py:15-36).

Produces an ``options_dict`` that *overrides* the driver's parameter dict
via ``parameters.update(parser.options_dict)`` (reference
lib/AbstractPhysics.py:17), completing the 3-tier config chain:
driver dict -> CLI flags -> options file (prefix-keyed DB).

The flag surface is table-driven: one FLAGS row per CLI option gives the
flag spelling, argparse kwargs, and the parameter-dict key it overrides
(None = handled specially).  ``--pc-dtype`` and ``--dtype`` are additions
over the reference (mixed-precision / device-precision operating points).  ``--device``
(cuda or cpu, default cuda) picks where the port runs; it is read by the
drivers (``options.device``) and overrides no parameter.
"""

from __future__ import annotations

import argparse

from .options import OptionsDB

# (flags, dest, parameter-dict key, argparse kwargs)
FLAGS = (
    (("-N", "--Nelements"), "N", "N",
     dict(type=int, help="mesh resolution: elements along each side")),
    (("--N-refinements",), "refinements", "mesh refinements",
     dict(type=int, help="extra uniform refinement rounds applied to the mesh")),
    (("--solver-type",), "solver_type", "solver type",
     dict(type=str, help="outer solver: gmres | cg | aar")),
    (("--pc-type",), "pc_type", "pc type",
     dict(type=str, help="block preconditioner variant (lu | undrained | "
          "diagonal | diagonal 3-way | diagonal 3-way-II | undrained 3-way)")),
    (("--fe-solid",), "fe_s", "fe degree solid",
     dict(type=int, help="polynomial degree for the displacement space")),
    (("--monitor",), "monitor", "solver monitor",
     dict(action="store_true",
          help="print per-iteration residuals of the outer solver")),
    (("--inner-monitor",), "inner_monitor", "inner monitor",
     dict(action="store_true",
          help="print final residuals of each inner (per-field) solve")),
    (("--inner-accel-order",), "inner_accel_order", "inner accel order",
     dict(type=int, help="history window for Anderson-accelerating the PC "
          "output (0 = off)")),
    (("--output",), "output", "output solutions",
     dict(action="store_true",
          help="write the solution time series to disk (XDMF)")),
    (("--time-final",), "tf", "tf",
     dict(type=float, help="simulation end time (overrides the driver default)")),
    (("--dtype",), "dtype", "dtype",
     dict(type=str, help="device dtype: float32 or float64")),
    (("--solver-chunk",), "solver_chunk", "solver chunk",
     dict(type=int, help="run the outer Krylov loop as python-level chunks "
          "of this many iterations (identical restart semantics when a "
          "multiple of the restart length; XLA:TPU long-f64-program "
          "workaround, see output/ANALYSIS.md §7)")),
    (("--pc-dtype",), "pc_dtype", "pc dtype",
     dict(type=str, help="preconditioner payload dtype (mixed precision: "
          "e.g. float32 under a float64 outer solve)")),
    (("--petsc-options",), "options_file", None,
     dict(type=str,
          help="per-prefix solver options file (PETSc options file syntax)")),
    (("--device",), "device", None,
     dict(type=str, choices=("cuda", "cpu"), default="cuda",
          help="where the solver runs: cuda (the card, default) or cpu "
          "(the kernels' plain PyTorch versions)")),
)


class Parser:
    def __init__(self, argv=None):
        ap = argparse.ArgumentParser(add_help=True)
        for flags, dest, _, kwargs in FLAGS:
            ap.add_argument(*flags, dest=dest, **kwargs)
        options, _ = ap.parse_known_args(argv)

        options_dict = {}
        for _, dest, key, _kw in FLAGS:
            val = getattr(options, dest)
            if key is not None and val:  # unset/zero/False flags don't override
                options_dict[key] = val
        if options.options_file:
            options_dict["options db"] = OptionsDB.from_file(options.options_file)
        self.options_dict = options_dict
        self.options = options

"""Shard every solver tree the drivers build, without processes, and list
the ``Transposed`` operators met on the way.

    python -m porotpu_torch.tools.shard_walk [--ns 2 3 4] [--world 4]

Builds, on the host, the robustness grid's 12 configurations ({swelling,
footing} x {2-way, 3-way} x the three options files) and the defaults of
the five drivers (swelling, footing, swelling_3d; the solid and
fluid-pressure subsystems' operator and PC), at each N of ``--ns``, and
shards each tree for rank 0 of ``--world`` ranks (``pad multiple`` the
world size; the subsystems, which are not padded, for one rank).  Prints
one line a tree: ``ok`` or the exception, and the ``Transposed``
operators ``shard_ell`` met, by (column space in slabs, inner DIA
embedded).  An embedded ``Transposed`` into a replicated space is the
one layout ``shard_ell`` does not port; exit status 1 if any tree raised.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class SlabMesh:
    """The rank and world of a mesh: no process.  Its halo matvecs split as
    under NCCL (``RowMesh.halo_split``)."""

    device = torch.device("cpu")
    halo_split = True

    def __init__(self, rank, world):
        from ..parallel.sharding import RowMesh

        self.rank, self.world = rank, world
        self.slab_len = RowMesh.slab_len.__get__(self)
        self.slab = RowMesh.slab.__get__(self)


def trees(ns, world):
    """(label, shard) for every tree: ``shard(mesh)`` shards it."""
    from ..drivers import fluid_pressure, footing, solid, swelling
    from ..models import benchmarks
    from ..parallel import sharding
    from ..precond.amg import AMG
    from ..utils.parser import Parser
    from . import robustness

    over = {"pad multiple": world}

    def problem(p):
        def shard(mesh):
            p._build_operators()
            p.row_mesh = mesh
            p._shard()
        return shard

    def subsystem(run):
        def shard(mesh):
            sharding.shard_operator(run.E, mesh, {})
            if isinstance(run.M, AMG):
                sharding.shard_amg(run.M, mesh, {})
            else:
                sizes = getattr(run.E, "sizes", None)
                fields = tuple(sizes.values()) if sizes else (run.E.shape[0],)
                sharding.shard_operator(run.M, mesh, {}, fields=fields)
        return shard

    cells = {c.case: c for c in robustness.GRID}
    for N in ns:
        for c in cells.values():
            drv = swelling if c.driver == "swelling" else footing
            argv = ["-N", str(N), "--petsc-options", os.path.join(ROOT, c.opts),
                    "--pc-type", c.pc, "--device", "cpu"]
            yield f"{c.case} N={N}", world, problem(drv.setup(argv, overrides=over))
        for name, drv in (("swelling", swelling), ("footing", footing)):
            yield (f"{name} defaults N={N}", world,
                   problem(drv.setup(["-N", str(N), "--device", "cpu"], overrides=over)))
        parser = Parser(["-N", str(N), "--device", "cpu"])
        yield (f"swelling_3d defaults N={N}", world,
               problem(benchmarks.swelling_3d(N, parser=parser, overrides=over, device="cpu")))
        for name, drv in (("solid", solid), ("fluid_pressure", fluid_pressure)):
            yield (f"{name} defaults N={N}", 1,
                   subsystem(drv.setup(["-N", str(N), "--device", "cpu"])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)

    from ..ops.dia import Transposed
    from ..parallel import sharding

    met = collections.Counter()
    shard_ell = sharding.shard_ell

    def spy(E, mesh, col_slab=True, memo=None):
        if isinstance(E, Transposed):
            met["slabs" if col_slab else "replicated",
                "embedded" if E.inner.col_emb is not None else "plain"] += 1
        return shard_ell(E, mesh, col_slab, memo)

    sharding.shard_ell = spy
    lines, failed = [], 0
    try:
        for label, world, shard in trees(args.ns, args.world):
            met.clear()
            try:
                shard(SlabMesh(0, world))
                status = "ok"
            except Exception as e:  # noqa: BLE001 (reported, and the exit status says so)
                status, failed = f"{type(e).__name__}: {e}", failed + 1
            lines.append(f"{label}: {status}; Transposed met "
                         + (", ".join(f"{a}/{b} {n}" for (a, b), n in sorted(met.items()))
                            or "none"))
    finally:
        sharding.shard_ell = shard_ell
    print("\n".join(lines))
    print(f"{len(lines)} trees, {failed} raised")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Pure-elasticity subsystem driver on the port (the counterpart of solid.py).

    python -m porotpu_torch.drivers.solid -N 16 [--dtype float64] [--petsc-options FILE] [--device cpu]

Assembles the solid block on a cube (``models.subsystems.solid_problem``)
and solves it with CG (rtol 1e-8, atol 0, maxiter 500), preconditioned by
the options file's ``s`` inner solver, else smoothed-aggregation AMG on
the rigid-body modes of the nodes.  f32 unless ``--dtype`` says otherwise,
as solid.py; it prints solid.py's "Dofs", "Assembled", "Solved in N
iterations" and "Final residual" lines.  It runs on the card and raises
without one, unless ``--device cpu`` is passed.
"""

import time

import torch

from porotpu_torch.models.abstract import log
from porotpu_torch.models.poromechanics import _resolve_dtype
from porotpu_torch.models.subsystems import SubsystemRun, device_of, solid_problem
from porotpu_torch.ops.dia import device_matrix
from porotpu_torch.precond.amg import rigid_body_modes
from porotpu_torch.precond.inner import InnerConfig, build_inner_solver
from porotpu_torch.solvers.cg import cg
from porotpu_torch.utils.parser import Parser


def setup(argv=None):
    """The system the command line asks for, assembled and on its device."""
    parser = Parser(argv)
    device = device_of(parser.options.device)
    N = parser.options.N or 10
    refinements = parser.options.refinements or 0
    dtype = _resolve_dtype(parser.options.dtype, torch.float32)

    tt = time.perf_counter()
    A, b, V, mesh = solid_problem(N, refinements)
    log("Dofs = {}".format(A.shape[0]))
    log("Assembled in {}s".format(time.perf_counter() - tt))

    odb = parser.options_dict.get("options db")
    cfg = odb.inner_config("s") if odb else None
    if cfg is None:
        cfg = InnerConfig(method="amg")

    tt = time.perf_counter()
    B = rigid_body_modes(V.node_coords)
    M = build_inner_solver(
        A, cfg, dofs_per_node=3, near_nullspace=B, coords=V.node_coords, dtype=dtype
    )
    E = device_matrix(A, dtype)
    M, E = M.to(device), E.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def solver(A_mv, bb, Mop):
        return cg(A_mv, bb, M=Mop, rtol=1e-8, atol=0.0, maxiter=500)

    return SubsystemRun(A, b, E, M, solver, dtype, device, time.perf_counter() - tt)


def main(argv=None):
    run = setup(argv)
    run.solve()
    return run


if __name__ == "__main__":
    main()

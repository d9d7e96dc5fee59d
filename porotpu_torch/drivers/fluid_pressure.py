"""Fluid-pressure subsystem driver on the port (the counterpart of fluid-pressure.py).

    python -m porotpu_torch.drivers.fluid_pressure -N 16 [--dtype float64] [--petsc-options FILE] [--device cpu]

Assembles the 2-field fluid/pressure system on a cube
(``models.subsystems.fluid_pressure_problem``) and solves it with FGMRES
(rtol 1e-8, atol 0, maxiter 300, unrestarted), preconditioned by the
lower Schur fieldsplit with the selfp Schur: the fluid by the options
file's ``fp_fieldsplit_0`` inner solver, else 10 cg+amg iterations, the
Schur part by ``fp_fieldsplit_1``, else dense LU.  The P1 pressure dofs
embed into the P2 fluid lattice, so the coupling blocks are banded.
Flags, dtype and printed lines as ``drivers.solid``.
"""

import time

import scipy.sparse as sp
import torch

from porotpu_torch.fem.dofmap import vertex_embedding
from porotpu_torch.models.abstract import log
from porotpu_torch.models.poromechanics import _resolve_dtype
from porotpu_torch.models.subsystems import SubsystemRun, device_of, fluid_pressure_problem
from porotpu_torch.ops.dia import device_matrix
from porotpu_torch.ops.sparse import FieldMatrix
from porotpu_torch.precond.inner import InnerConfig
from porotpu_torch.precond.schur import build_schur_fieldsplit
from porotpu_torch.solvers.gmres import fgmres
from porotpu_torch.utils.parser import Parser


def setup(argv=None):
    """The system the command line asks for, assembled and on its device."""
    parser = Parser(argv)
    device = device_of(parser.options.device)
    N = parser.options.N or 10
    refinements = parser.options.refinements or 0
    dtype = _resolve_dtype(parser.options.dtype, torch.float32)

    tt = time.perf_counter()
    blocks, b, W, mesh = fluid_pressure_problem(N, refinements)
    log("Dofs = {}".format(b.shape[0]))
    log("Assembled in {}s".format(time.perf_counter() - tt))

    odb = parser.options_dict.get("options db")
    cfg_f = (odb.inner_config("fp_fieldsplit_0") if odb else None) or InnerConfig(
        method="cg+amg", iters=10
    )
    cfg_S = (odb.inner_config("fp_fieldsplit_1") if odb else None) or InnerConfig(
        method="lu"
    )

    tt = time.perf_counter()
    Vf, Qp = W.space("f"), W.space("p")
    emb_pf = vertex_embedding(Qp, Vf)
    M = build_schur_fieldsplit(
        blocks["f", "f"],
        blocks["f", "p"],
        blocks["p", "f"],
        blocks["p", "p"],
        cfg_f,
        cfg_S,
        dofs_per_node_f=3,
        coords_f=Vf.node_coords,
        coords_p=Qp.node_coords,
        row_emb_pf=emb_pf,
        dtype=dtype,
    )
    A = sp.bmat(
        [
            [blocks["f", "f"], blocks["f", "p"]],
            [blocks["p", "f"], blocks["p", "p"]],
        ],
        format="csr",
    )
    embs = {
        ("f", "p"): dict(col_emb=emb_pf),
        ("p", "f"): dict(row_emb=emb_pf),
    }
    E = FieldMatrix(
        {
            k: device_matrix(v.tocsr(), dtype, **embs.get(k, {}))
            for k, v in blocks.items()
            if v.nnz
        },
        {"f": Vf.num_dofs, "p": Qp.num_dofs},
    )
    M, E = M.to(device), E.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def solver(A_mv, bb, Mop):
        return fgmres(A_mv, bb, M=Mop, rtol=1e-8, atol=0.0, maxiter=300)

    return SubsystemRun(A, b, E, M, solver, dtype, device, time.perf_counter() - tt)


def main(argv=None):
    run = setup(argv)
    run.solve()
    return run


if __name__ == "__main__":
    main()

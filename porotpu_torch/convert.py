"""Carry porotpu's device objects across into the port's modules.

``to_torch(obj)`` rebuilds a porotpu operator or preconditioner tree —
FieldMatrix, DIA (with dataT, col_emb, ne), Transposed, Dense, ELL, AMG,
InnerSolver, SchurFieldsplit, the 2-way and 3-way BlockPreconditioner and
CastPC — from ``np.asarray`` of its array leaves.  Classes are recognized
by name, so this module imports no jax; the caller passes objects it
already has.

Tests use it to tell the two halves of the port apart: an apply that
disagrees on converted objects is an apply fault, one that agrees there
but not on the port's own build is a host-setup fault.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.dia import DIA, Dense, Transposed
from .ops.sparse import ELL, FieldMatrix, ell_transpose
from .precond.amg import AMG, AMGLevel
from .precond.block import BlockPreconditioner, CastPC
from .precond.inner import InnerSolver
from .precond.schur import SchurFieldsplit


def _tensor(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _torch_dtype(dt):
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def to_torch(obj, _memo=None):
    """The port's counterpart of a porotpu object (shared leaves stay shared)."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]

    def conv(o):
        return to_torch(o, memo)

    name = type(obj).__name__
    if name == "DIA":
        emb = None if obj.col_emb is None else np.asarray(obj.col_emb)
        out = DIA(
            _tensor(obj.data), obj.offsets, obj.nrows, obj.ncols,
            col_emb=emb, ne=obj.ne, dataT=_tensor(obj.dataT),
        )
    elif name == "Transposed":
        out = Transposed(conv(obj.inner))
    elif name == "Dense":
        out = Dense(_tensor(obj.data))
    elif name == "ELL":
        # the port's ELL transposes through a stored transposed layout
        dT, colsT = ell_transpose(np.asarray(obj.data, dtype=np.float64), np.asarray(obj.cols),
                                  obj.ncols)
        data = _tensor(obj.data)
        out = ELL(data, _tensor(obj.cols, torch.int32), obj.ncols,
                  torch.as_tensor(dT, dtype=data.dtype), torch.from_numpy(colsT))
    elif name == "FieldMatrix":
        out = FieldMatrix({k: conv(v) for k, v in obj.blocks.items()}, obj.sizes)
    elif name == "AMG":
        levels = [
            AMGLevel(conv(lv.A), conv(lv.P), _tensor(lv.dinv), lv.lmax)
            for lv in obj.levels
        ]
        out = AMG(
            levels, _tensor(obj.coarse_inv), obj.presmooth, obj.postsmooth,
            obj.cheb_lower,
        )
    elif name == "InnerSolver":
        payload = {
            k: (conv(v) if type(v).__module__.startswith("porotpu.") else _tensor(v))
            for k, v in obj.payload.items()
        }
        out = InnerSolver(obj.kind, payload, iters=obj.iters, lmax=obj.lmax,
                          cheb_frac=obj.cheb_frac)
    elif name == "SchurFieldsplit":
        out = SchurFieldsplit(
            obj.nf, conv(obj.solve_f), conv(obj.solve_S), conv(obj.Apf)
        )
    elif name == "BlockPreconditioner":
        opt = lambda o: None if o is None else conv(o)  # noqa: E731
        out = BlockPreconditioner(
            obj.ns, obj.nf, obj.np_, conv(obj.solve_s), opt(obj.solve_fp),
            opt(obj.Pfs), opt(obj.Pps), three_way=obj.three_way,
            solve_f=opt(obj.solve_f), solve_p=opt(obj.solve_p),
            solve_diff=opt(obj.solve_diff), Pfp=opt(obj.Pfp), Psf=opt(obj.Psf),
            Psp=opt(obj.Psp), diff_rhs_mask=_tensor(obj.diff_rhs_mask),
            w1=obj.w1, w2=obj.w2,
        )
    elif name == "CastPC":
        out = CastPC(conv(obj.inner), _torch_dtype(obj.out_dtype), _torch_dtype(obj.in_dtype))
    else:
        raise TypeError(f"no port counterpart for {type(obj).__module__}.{name}")
    memo[id(obj)] = out
    return out

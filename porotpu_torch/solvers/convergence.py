"""Field-wise convergence test (porotpu/solvers/convergence.py).

Residual split into contiguous field segments; error_abs is the max
field infinity-norm, error_rel divides it by the max per-field 2-norm of
the initial RHS (reference lib/Solver.py:8-51).  On a row mesh the
segments are the rank's field slabs: the per-field maxima are one
all-reduce, the per-field sums of squares of the RHS another.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class FieldwiseTest:
    """Per-field infinity-norm convergence test over contiguous segments."""

    offsets: tuple  # (0, ns, ns+nf, n)
    b0_norms: torch.Tensor  # (nfields,) per-field 2-norms of the initial RHS
    mesh: object = None  # the row mesh: offsets are then the local slabs'

    @classmethod
    def from_sizes(cls, sizes, b, mesh=None):
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + int(s))
        segs = [b[offs[i] : offs[i + 1]] for i in range(len(sizes))]
        if mesh is None:
            b0 = torch.stack([torch.linalg.norm(v) for v in segs])
        else:
            b0 = torch.sqrt(mesh.allreduce_sum(torch.stack([torch.dot(v, v) for v in segs])))
        return cls(tuple(offs), b0, mesh)

    @property
    def nfields(self):
        return len(self.offsets) - 1

    def field_norms(self, r: torch.Tensor) -> torch.Tensor:
        res = torch.stack(
            [
                torch.max(torch.abs(r[self.offsets[i] : self.offsets[i + 1]]))
                for i in range(self.nfields)
            ]
        )
        return res if self.mesh is None else self.mesh.allreduce_max(res)

    def errors(self, r: torch.Tensor):
        """(error_abs, error_rel) as 0-d tensors on r's device."""
        res = self.field_norms(r)
        normalize = torch.max(self.b0_norms)
        error_abs = torch.max(res)
        error_rel = error_abs / torch.where(
            normalize > 0, normalize, torch.ones_like(normalize)
        )
        return error_abs, error_rel

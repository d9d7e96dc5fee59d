"""Physics-based block preconditioner, 2-way variant (porotpu/precond/block.py).

    ys  = solve_s(xs)
    yfp = solve_fp(x_fp - [Pfs ys; Pps ys])

(reference lib/Preconditioner.py:219-241).  The 3-way double sweep and
the mixed-precision ``CastPC`` wrapper are not ported yet (ROADMAP M7.1).
"""

from __future__ import annotations

import torch
from torch import nn


class BlockPreconditioner(nn.Module):
    def __init__(self, ns, nf, np_, solve_s, solve_fp, Pfs, Pps):
        super().__init__()
        self.ns, self.nf, self.np_ = ns, nf, np_
        self.solve_s = solve_s
        self.solve_fp = solve_fp
        self.Pfs = Pfs  # fluid rows of the fp-s coupling
        self.Pps = Pps  # pressure rows of the fp-s coupling

    def forward(self, x):
        ns = self.ns
        ys = self.solve_s(x[:ns])
        coup = torch.cat([self.Pfs.matvec(ys), self.Pps.matvec(ys)])
        yfp = self.solve_fp(x[ns:] - coup)
        return torch.cat([ys, yfp])

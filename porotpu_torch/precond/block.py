"""Physics-based block preconditioner (porotpu/precond/block.py).

2-way (reference lib/Preconditioner.py:219-241):
    ys  = solve_s(xs)
    yfp = solve_fp(x_fp - [Pfs ys; Pps ys])

3-way (lib/Preconditioner.py:150-212): two lower triangular sweeps p -> f
-> s, one from the stabilized pressure block (``solve_p``), one from the
pressure-diffusion block (``solve_diff``, on the pressure input with its
Dirichlet rows zeroed by ``diff_rhs_mask``), summed as
``w1 * y_FS + w2 * y_diff``.  Each apply runs ``solve_f`` and ``solve_s``
twice; the inner solvers keep no state between calls, so the two sweeps
do not couple.

``CastPC`` applies a PC built at a lower precision inside a
higher-precision outer solve.

With tracing on (``utils.trace``) an apply is one ``pc.apply`` span and
each inner solve in it one ``pc.<label>`` span (``inner.BLOCK_LABELS``);
the couplings run in the apply's span, outside every stage's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import trace
from .inner import BLOCK_LABELS

# the span of each inner solve: pc.s, pc.fp, pc.f, pc.p, pc.diff
STAGE_SPANS = {attr: "pc." + label for attr, label in BLOCK_LABELS.items()}


class BlockPreconditioner(nn.Module):
    """The 2-way sweep, or with ``three_way`` the 3-way double sweep; the
    variant is fixed at construction, as porotpu's."""

    def __init__(
        self, ns, nf, np_, solve_s, solve_fp=None, Pfs=None, Pps=None, *,
        three_way=False, solve_f=None, solve_p=None, solve_diff=None,
        Pfp=None, Psf=None, Psp=None, diff_rhs_mask=None, w1=1.0, w2=0.1,
    ):
        super().__init__()
        self.ns, self.nf, self.np_ = ns, nf, np_
        self.three_way = bool(three_way)
        self.solve_s = solve_s
        self.solve_fp = solve_fp
        self.Pfs = Pfs  # fluid rows of the fp-s coupling
        self.Pps = Pps  # pressure rows of the fp-s coupling
        self.solve_f, self.solve_p, self.solve_diff = solve_f, solve_p, solve_diff
        self.Pfp, self.Psf, self.Psp = Pfp, Psf, Psp  # 3-way couplings Mf_p, Ms_f, Ms_p
        self.register_buffer("diff_rhs_mask", diff_rhs_mask)
        self.w1, self.w2 = float(w1), float(w2)

    @trace.spanned(trace.PC_APPLY)
    def forward(self, x):
        if self.three_way:
            return self._three_way(x)
        ns = self.ns
        ys = self._stage("solve_s", x[:ns])
        coup = torch.cat([self.Pfs.matvec(ys), self.Pps.matvec(ys)])
        yfp = self._stage("solve_fp", x[ns:] - coup)
        return torch.cat([ys, yfp])

    def _stage(self, attr, b):
        """The inner solve ``attr`` of ``b``, under its stage's span."""
        with trace.span(STAGE_SPANS[attr]):
            return getattr(self, attr)(b)

    def _three_way(self, x):
        ns, nf = self.ns, self.nf
        xs, xf, xp = x[:ns], x[ns : ns + nf], x[ns + nf :]
        yp = self._stage("solve_p", xp)
        yp_diff = self._stage("solve_diff", xp * self.diff_rhs_mask)
        yf = self._stage("solve_f", xf - self.Pfp.matvec(yp))
        yf_diff = self._stage("solve_f", xf - self.Pfp.matvec(yp_diff))
        ys = self._stage("solve_s", xs - self.Psf.matvec(yf) - self.Psp.matvec(yp))
        ys_diff = self._stage("solve_s", xs - self.Psf.matvec(yf_diff) - self.Psp.matvec(yp_diff))
        y_fs = torch.cat([ys, yf, yp])
        y_diff = torch.cat([ys_diff, yf_diff, yp_diff])
        return self.w1 * y_fs + self.w2 * y_diff


class CastPC(nn.Module):
    """Mixed-precision wrapper (porotpu/precond/block.py:122-150): the input
    is cast to the PC's dtype ``in_dtype``, the wrapped PC applied, and the
    result cast back to the outer solve's dtype ``out_dtype``.  With right
    preconditioning the PC only maps residuals to search directions, so
    its precision moves the iteration count, never the accuracy FGMRES
    reaches on the true residual."""

    def __init__(self, inner, out_dtype: torch.dtype, in_dtype: torch.dtype):
        super().__init__()
        self.inner = inner
        self.out_dtype = out_dtype
        self.in_dtype = in_dtype

    def forward(self, x):
        return self.inner(x.to(self.in_dtype)).to(self.out_dtype)

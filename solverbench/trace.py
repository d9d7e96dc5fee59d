"""Reading the profiler's trace of the traced steps, and the spans and
byte counts the harness wraps around the port's products.

The arithmetic follows tools/profile_torch_solve.py (device time of the
kernels by name, over the wall time), rewritten on the raw events of the
trace: the window is the harness's ``solverbench.window`` span, the
device is busy where the union of its operations' intervals lies, and a
kernel belongs to a span when the host call that launched it (its
correlation id) ran inside the span.  The profiler stretches the host's
time in the window, not the device's: busy seconds and kernel times hold,
the idle gaps are longer than in an untraced step.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

WINDOW = "solverbench.window"
ELL_SPAN = "solverbench.ell"
K1_KERNEL = "dia_mv_kernel"
K2_KERNEL = "dia_rmv_kernel"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
_LAUNCHES = ("cudaLaunch", "cuLaunch")
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


@dataclasses.dataclass
class Products:
    """Calls and bytes of the banded (K1, K2) and ELL products launched
    while the recorder is installed."""

    k1_calls: int = 0
    k1_bytes: int = 0
    k2_calls: int = 0
    k2_bytes: int = 0
    ell_calls: int = 0
    ell_bytes: int = 0


def install_recorder(products: Products):
    """Wrap the port's K1/K2 launch functions and ELL products so that each
    call adds its bytes (``roofline``) to ``products`` and each ELL product
    runs under an ``ELL_SPAN`` span; returns the function that undoes it."""
    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.ops.sparse import ELL

    from .roofline import dia_bytes, ell_bytes

    orig = (dia_kernel.dia_mv, dia_kernel.dia_rmv, ELL.matvec, ELL.rmatvec)
    dia_mv, dia_rmv, ell_mv, ell_rmv = orig

    def k1(data, offsets, xe, groups_of=None):
        nd, nrows = data.shape
        if nd and nrows:
            products.k1_calls += 1
            products.k1_bytes += dia_bytes(nd, nrows, xe.shape[0], nrows, data.element_size())
        return dia_mv(data, offsets, xe, groups_of)

    def k2(data, offsets, x, ne):
        nd, nrows = data.shape
        if nd and nrows and ne:
            products.k2_calls += 1
            products.k2_bytes += dia_bytes(nd, nrows, nrows, ne, data.element_size())
        return dia_rmv(data, offsets, x, ne)

    def mv(self, x):
        n, width = self.data.shape
        products.ell_calls += 1
        products.ell_bytes += ell_bytes(n, width, x.shape[0], self.data.element_size(),
                                        self.cols.element_size())
        with torch.profiler.record_function(ELL_SPAN):
            return ell_mv(self, x)

    def rmv(self, x):
        if self.dataT is not None:
            n, width = self.dataT.shape
            products.ell_calls += 1
            products.ell_bytes += ell_bytes(n, width, x.shape[0], self.dataT.element_size(),
                                            self.colsT.element_size())
        with torch.profiler.record_function(ELL_SPAN):
            return ell_rmv(self, x)

    dia_kernel.dia_mv, dia_kernel.dia_rmv = k1, k2
    ELL.matvec, ELL.rmatvec = mv, rmv
    ELL.forward = mv

    def restore():
        dia_kernel.dia_mv, dia_kernel.dia_rmv, ELL.matvec, ELL.rmatvec = orig
        ELL.forward = ell_mv

    return restore


@dataclasses.dataclass
class Event:
    name: str
    device: bool
    start: int  # ns
    end: int  # ns
    corr: int
    annotation: bool = False  # a span (record_function); the device copy of one is no operation


def raw_events(prof) -> list[Event]:
    """The profiler's events as plain records, without the event tree
    torch builds for ``prof.events()`` (slow at a million events)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        start = int(e.start_ns())
        out.append(Event(e.name(), dev, start, start + int(e.duration_ns()),
                         int(e.correlation_id()), bool(e.is_user_annotation())))
    return out


def _union(intervals):
    """Merged (start, end) intervals of a list of intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


@dataclasses.dataclass
class Trace:
    """What the traced window holds, reduced for the metric readers."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: int = 0
    k1_s: float = 0.0
    k1_launches: int = 0
    k2_s: float = 0.0
    k2_launches: int = 0
    ell_s: float = 0.0
    ell_spans: int = 0  # ELL spans in the window (the products the trace saw)
    device_ops: list = dataclasses.field(default_factory=list)  # [name, s], most first
    idle_gaps: list = dataclasses.field(default_factory=list)  # [host op, s], most first


def reduce_trace(events: list[Event], top: int = 10) -> Trace | None:
    """The window's busy time, kernel counts and times, the ELL spans'
    kernel time, and the breakdown; None when the trace has no window."""
    windows = [e for e in events if not e.device and e.name == WINDOW]
    if not windows:
        return None
    w = windows[0]
    lo, hi = w.start, w.end
    tr = Trace(window_s=(hi - lo) * 1e-9)
    dev = [e for e in events if e.device and not e.annotation and e.end > lo and e.start < hi]
    busy = _union([(max(e.start, lo), min(e.end, hi)) for e in dev])
    tr.busy_s = sum(e - s for s, e in busy) * 1e-9

    by_name = collections.Counter()
    by_corr = {}
    for e in dev:
        dur = (e.end - e.start) * 1e-9
        by_name[e.name] += dur
        if e.name.startswith(_NOT_KERNELS):
            continue
        tr.kernels += 1
        by_corr[e.corr] = by_corr.get(e.corr, 0.0) + dur
        if K1_KERNEL in e.name:
            tr.k1_s += dur
            tr.k1_launches += 1
        elif K2_KERNEL in e.name:
            tr.k2_s += dur
            tr.k2_launches += 1
    tr.device_ops = [[n[:NAME_CHARS], s] for n, s in by_name.most_common(top)]

    host = sorted((e for e in events if not e.device
                   and e.end > lo and e.start < hi and e is not w),
                  key=lambda e: (e.start, -e.end))
    # kernels launched inside an ELL span (by the launch's correlation id)
    spans = [e for e in host if e.name == ELL_SPAN]
    tr.ell_spans = len(spans)
    launches = [e for e in host if e.name.startswith(_LAUNCHES)]
    j = 0
    for sp in spans:
        while j < len(launches) and launches[j].start < sp.start:
            j += 1
        k = j
        while k < len(launches) and launches[k].start < sp.end:
            c = launches[k].corr
            tr.ell_s += by_corr.get(c, 0.0)
            k += 1

    # each idle gap of the device, named by the innermost host event that
    # was running at its middle
    gaps = []
    prev = lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    idle = collections.Counter()
    stack, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end <= mid:
            stack.pop()
        idle[stack[-1].name if stack else "host, outside any op"] += (g1 - g0) * 1e-9
    tr.idle_gaps = [[n[:NAME_CHARS], s] for n, s in idle.most_common(top)]
    return tr

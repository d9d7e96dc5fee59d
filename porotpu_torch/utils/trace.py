"""Spans and a host-sync counter inside the solve, off by default.

    from porotpu_torch.utils import trace
    trace.enable()                  # enable(annotate=True) under torch.profiler
    problem.solve()
    trace.totals()["pc.apply"]      # Total(count, seconds, host_syncs)
    trace.host_syncs()
    trace.counts()["setup.galerkin.row_blocked"]

While tracing is on, a span (``span(name)``, a context manager) appends
one record: its name, its start and end on ``time.perf_counter_ns``, the
index of the record it opened inside (-1 at the top), and the time step
it belongs to: every span opened inside one ``step`` span shares that
step's number (-1 outside a step).  With ``annotate=True`` a span also
enters ``torch.profiler.record_function(name)``, so that its host
interval lies on the profiler's clock beside the device's kernels.

The counter ``host_syncs`` counts the points where the host waits for
the device's queue to drain: ``host_read`` (a blocking device-to-host
read), ``host_copy`` (a blocking copy between the host and the device)
and ``synchronize``.  Each adds 1 to the record of the innermost open
span and to the total.  They count on every device, so that a run on the
CPU counts the waits a run on the card makes.  ``count(name)`` adds to a
named counter of its own (``counts``).

Off, ``span`` returns one shared no-op context manager, the sync points
only do their work, and nothing is recorded or called in
``torch.profiler``.  Records stay in memory until ``reset``.

The spans, each at one place in the program:

- ``step``: ``Poromechanics.solve_time_step``, the whole step;
- ``pc.apply``: ``BlockPreconditioner.forward``, 2-way and 3-way;
- ``pc.s``, ``pc.f``, ``pc.p``, ``pc.diff``, ``pc.fp``: each inner solve
  of the block PC, named by ``precond.inner.BLOCK_LABELS``;
- ``setup.amg``: ``precond.amg.amg_setup``, each AMG hierarchy's host
  setup;
- ``setup.galerkin``: ``precond.amg.matmul``, each sparse product of the
  hierarchy's setup (smoothing P, the Galerkin coarse operator), inside
  ``setup.amg``.

The named counters: ``setup.galerkin.row_blocked``, the products that
ran in row blocks on the host's thread pool.

``banded_totals()`` sums the banded products' counters, which
``ops.dia_kernel`` keeps always on, tracing or not, until its
``reset_counts()``: the diagonal values the K1 and K2 products streamed,
how many of them are structural nonzeros, and K1's values by the path of
its launch (vector or scalar).

``Poromechanics.print_timings`` reads all of them and the counters.  No
span goes below a block PC stage: a product or a launch has none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import torch

from ..ops import dia_kernel

STEP = "step"
PC_APPLY = "pc.apply"
AMG_SETUP = "setup.amg"
GALERKIN = "setup.galerkin"
ROW_BLOCKED = "setup.galerkin.row_blocked"

_NOOP = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    """One span."""

    name: str
    start: int  # ns, time.perf_counter_ns
    end: int  # ns; 0 while the span is open
    parent: int  # index of the enclosing record, -1 at the top
    step: int  # the time step's number, -1 outside a step
    host_syncs: int = 0  # sync points while this was the innermost open span

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclasses.dataclass
class Total:
    """The closed records of one name, summed."""

    count: int = 0
    seconds: float = 0.0
    host_syncs: int = 0


class _State:
    on = False
    annotate = False
    records: list = []
    open: list = []  # indices of the open records, innermost last
    steps = 0  # step spans opened since the last reset
    syncs = 0  # sync points since the last reset, inside and outside spans
    counts: dict = {}  # the named counters since the last reset


_S = _State()


def enable(annotate: bool = False):
    """Record spans and count sync points from now on; with ``annotate``
    each span is also a ``torch.profiler.record_function``."""
    _S.on = True
    _S.annotate = bool(annotate)


def disable():
    """Stop recording; the records stay.  A span open now still closes its
    record."""
    _S.on = False
    _S.annotate = False


def reset():
    """Drop the records and zero the counter and the step numbers."""
    if _S.open:
        raise RuntimeError(f"trace.reset inside {len(_S.open)} open span(s)")
    _S.records = []
    _S.steps = 0
    _S.syncs = 0
    _S.counts = {}


class _Span:
    __slots__ = ("name", "idx", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        recs, parent = _S.records, (_S.open[-1] if _S.open else -1)
        if self.name == STEP:
            step = _S.steps
            _S.steps += 1
        else:
            step = recs[parent].step if parent >= 0 else -1
        if _S.annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.idx = len(recs)
        recs.append(Record(self.name, time.perf_counter_ns(), 0, parent, step))
        _S.open.append(self.idx)
        return self

    def __exit__(self, *exc):
        _S.records[self.idx].end = time.perf_counter_ns()
        _S.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records ``name`` while tracing is on."""
    return _Span(name) if _S.on else _NOOP


def spanned(name: str):
    """A decorator: each call of the function runs under ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _count():
    _S.syncs += 1
    if _S.open:
        _S.records[_S.open[-1]].host_syncs += 1


def host_read(t: torch.Tensor, numpy: bool = False):
    """The blocking device-to-host read: ``t.tolist()``, or with ``numpy``
    ``t.cpu().numpy()``."""
    if _S.on:
        _count()
    return t.cpu().numpy() if numpy else t.tolist()


def host_copy(t: torch.Tensor, device, copy: bool = False) -> torch.Tensor:
    """A blocking copy of ``t`` to ``device``, to or from the host:
    ``t.to(device, copy=copy)``."""
    if _S.on:
        _count()
    return t.to(device, copy=copy)


def synchronize(device):
    """Wait for the device's queue (``torch.cuda.synchronize`` on a card)."""
    if _S.on:
        _count()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def count(name: str):
    """Add 1 to the counter ``name`` while tracing is on."""
    if _S.on:
        _S.counts[name] = _S.counts.get(name, 0) + 1


def counts() -> dict[str, int]:
    """The named counters since the last reset."""
    return dict(_S.counts)


def records() -> list[Record]:
    """The records since the last reset, in the order they opened."""
    return list(_S.records)


def totals() -> dict[str, Total]:
    """The closed records summed by name."""
    out: dict[str, Total] = {}
    for r in _S.records:
        if r.end:
            t = out.setdefault(r.name, Total())
            t.count += 1
            t.seconds += r.seconds
            t.host_syncs += r.host_syncs
    return out


@dataclasses.dataclass
class Banded:
    """The banded products' counters (``ops.dia_kernel``), summed."""

    stored: int = 0  # diagonal values of the K1 and K2 products that report their nnz
    nonzero: int = 0  # the structural nonzeros among them
    k1_vector: int = 0  # K1's stored values launched on the vector path
    k1_scalar: int = 0  # and on the scalar path

    @property
    def fill(self) -> float | None:
        """Percent of the stored values that are structural zeros."""
        return 100.0 * (self.stored - self.nonzero) / self.stored if self.stored else None

    @property
    def k1_scalar_share(self) -> float | None:
        """Percent of K1's stored values on the scalar path."""
        k1 = self.k1_vector + self.k1_scalar
        return 100.0 * self.k1_scalar / k1 if k1 else None


def banded_totals() -> Banded:
    """The banded products since ``dia_kernel.reset_counts()``."""
    return Banded(sum(dia_kernel.STORED.values()), sum(dia_kernel.NONZERO.values()),
                  dia_kernel.K1_PATH["vector"], dia_kernel.K1_PATH["scalar"])


def host_syncs() -> int:
    """Sync points counted since the last reset, inside and outside spans."""
    return _S.syncs

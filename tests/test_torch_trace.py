"""The port's spans and host-sync counter (porotpu_torch/utils/trace.py)
on the CPU, through the swelling driver at N=3.

- Tracing changes no number: the iteration counts and every solution of
  two steps are bit for bit those of the same run with tracing off, with
  the 2-way and the 3-way block PC (petsc-options-inexact).
- The spans: one ``pc.apply`` a PC application, its stages (3-way:
  ``pc.s`` and ``pc.f`` twice, ``pc.p`` and ``pc.diff`` once; 2-way:
  ``pc.s`` and ``pc.fp`` once) inside it, every span of a step under that
  step's ``step`` span and number, one ``setup.amg`` a hierarchy built.
- The counter: with counting shims on the tensor methods that read the
  device (``item``, ``tolist``, ``cpu``, ``__float__``, ``__bool__``,
  ``__int__``), and on ``Tensor.to`` for blocking moves to a device,
  ``host_syncs`` counts every one of them in ``solve_time_step``, plus the
  step's synchronize, for the outer fgmres, cg and aar: no blocking read
  escapes it.
- Off, ``span`` is the one shared no-op and nothing is recorded or
  counted; ``annotate`` puts the spans on the profiler's timeline.
- ``print_timings`` prints the reference's lines from the spans, the AMG
  line with its ``setup.galerkin`` products and how many ran in row
  blocks, and with no span recorded the Solver line alone; then, tracing
  or not, the banded products' line from ``dia_kernel``'s counters.
"""

import os
import re
import sys

import pytest
import torch

from porotpu_torch.drivers import swelling
from porotpu_torch.precond import amg
from porotpu_torch.precond.amg import AMG
from porotpu_torch.utils import trace
from torch_k1_cases import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INEXACT = os.path.join(REPO, "petsc-options-inexact")
# name -> driver flags; the options file sets -global_ksp_type gmres
RUNS = {
    "2way": ["--petsc-options", INEXACT],
    "3way": ["--petsc-options", INEXACT, "--pc-type", "diagonal 3-way"],
}
# the outer solvers at the drivers' defaults (no options file to shadow them)
SOLVERS = {"fgmres": [], "cg": ["--solver-type", "cg"], "aar": ["--solver-type", "aar"]}
STAGES = {"2way": {"pc.s": 1, "pc.fp": 1}, "3way": {"pc.s": 2, "pc.f": 2, "pc.p": 1, "pc.diff": 1}}
STEPS = 2
# the plain kernels read offsets the host holds; they never run on a card
PLAIN = os.path.join("porotpu_torch", "ops", "dia_kernel.py")
TRACE_FILE = os.path.join("porotpu_torch", "utils", "trace.py")


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _problem(flags, overrides=None):
    argv = ["-N", "3", "--device", "cpu", *flags]
    return swelling.setup(argv, dict(overrides or {}, tf=1.0))


def _steps(problem, n=STEPS):
    """``n`` time steps after the problem's t0: their iteration counts and
    solutions."""
    its, sols, t = [], [], problem.t0
    for _ in range(n):
        t += problem.dt
        its.append(problem.solve_time_step(t))
        sols.append(problem.sol.clone())
    return its, sols


_TRACED = {}


def _traced(name):
    """A run of ``name``: solver built and two steps solved with tracing
    on, its records; built once a module."""
    if name not in _TRACED:
        trace.reset()
        problem = _problem(RUNS[name])
        trace.enable()
        problem.create_solver()
        problem.first_timestep = False
        applies = problem.pc_applies
        its, sols = _steps(problem)
        trace.disable()
        _TRACED[name] = problem, its, sols, problem.pc_applies - applies, trace.records()
        trace.reset()
    return _TRACED[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_tracing_changes_no_number(name):
    problem, its, sols, _, _ = _traced(name)
    off = _problem(RUNS[name])
    its_off, sols_off = _steps(off)
    assert trace.records() == [] and trace.host_syncs() == 0
    assert its == its_off and off.iteration_log == problem.iteration_log
    for a, b in zip(sols, sols_off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(RUNS))
def test_spans_nest_and_count(name):
    problem, its, _, applies, recs = _traced(name)
    by_name = {}
    for i, r in enumerate(recs):
        assert r.end >= r.start > 0
        by_name.setdefault(r.name, []).append(i)
    steps = by_name[trace.STEP]
    assert [recs[i].step for i in steps] == list(range(STEPS))
    assert all(recs[i].parent == -1 for i in steps)
    # every application of the PC is one pc.apply span, inside a step
    pcs = by_name[trace.PC_APPLY]
    assert len(pcs) == applies == sum(its) > 0
    for i in pcs:
        assert recs[recs[i].parent].name == trace.STEP
        assert recs[i].step == recs[recs[i].parent].step
    per_step = [sum(recs[i].step == s for i in pcs) for s in range(STEPS)]
    assert per_step == its
    # each apply's stages are its children, as many as the sweep solves
    for i in pcs:
        kids = [r.name for r in recs if r.parent == i]
        assert {k: kids.count(k) for k in set(kids)} == STAGES[name]
    assert set(by_name) == {trace.STEP, trace.PC_APPLY, trace.AMG_SETUP, *STAGES[name]}
    # one setup.amg a hierarchy of the PC, outside every step
    amgs = [i for i in by_name[trace.AMG_SETUP] if recs[i].parent == -1]
    assert len(amgs) == len(by_name[trace.AMG_SETUP])
    assert len(amgs) == sum(isinstance(m, AMG) for m in problem.pc.modules()) > 0
    assert all(recs[i].step == -1 for i in amgs)


def _count_shims(monkeypatch):
    """Count the device reads and the blocking moves to a device that the
    program makes outside the plain kernels; returns the counter."""
    counts = {"read": 0, "copy": 0, "where": []}

    def caller():
        f = sys._getframe(2)
        return f.f_code.co_filename, f.f_lineno

    def outside(path):
        return not path.endswith(PLAIN)

    for meth in ("item", "tolist", "cpu", "__float__", "__bool__", "__int__"):
        orig = getattr(torch.Tensor, meth)

        def read(self, *args, _orig=orig, **kwargs):
            path, line = caller()
            if outside(path):
                counts["read"] += 1
                counts["where"].append((path, line))
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, meth, read)
    to = torch.Tensor.to

    def moved(self, *args, **kwargs):
        dev = kwargs.get("device")
        for a in args:
            if isinstance(a, (torch.device, str)):
                dev = a
        path, line = caller()
        if dev is not None and not kwargs.get("non_blocking", False) and outside(path):
            counts["copy"] += 1
            counts["where"].append((path, line))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", moved)
    return counts


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_host_syncs_count_every_blocking_read(solver, monkeypatch):
    problem = _problem(SOLVERS[solver], {"solver maxiter": 12})
    problem.create_solver()
    problem.first_timestep = False
    t = problem.t0 + problem.dt
    trace.enable()
    with monkeypatch.context() as m:
        counts = _count_shims(m)
        its = problem.solve_time_step(t)
    trace.disable()
    assert its > 0 and counts["read"] > its
    # each sync point is one shimmed call, made inside trace.py
    assert all(path.endswith(TRACE_FILE) for path, _ in counts["where"]), counts["where"]
    # and the step's synchronize, a call into torch.cuda on a card alone
    assert trace.host_syncs() == counts["read"] + counts["copy"] + 1
    step = trace.totals()[trace.STEP]
    assert step.count == 1 and sum(t.host_syncs for t in trace.totals().values()) == (
        trace.host_syncs())


def test_off_records_nothing():
    assert trace.span("pc.apply") is trace.span(trace.STEP)
    with trace.span("pc.apply"):
        assert trace.host_read(torch.arange(3.0)) == [0.0, 1.0, 2.0]
    trace.synchronize("cpu")
    assert trace.records() == [] and trace.totals() == {} and trace.host_syncs() == 0


def test_spans_records_and_annotations():
    trace.enable(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span(trace.STEP):
            with trace.span(trace.PC_APPLY):
                with trace.span("pc.s"):
                    trace.host_read(torch.ones(2), numpy=True)
                trace.host_copy(torch.ones(2), "cpu")
            trace.synchronize("cpu")
        with trace.span(trace.STEP):
            pass
        with trace.span(trace.AMG_SETUP):
            trace.host_read(torch.ones(()))
    trace.disable()
    recs = trace.records()
    assert [(r.name, r.parent, r.step, r.host_syncs) for r in recs] == [
        (trace.STEP, -1, 0, 1), (trace.PC_APPLY, 0, 0, 1), ("pc.s", 1, 0, 1),
        (trace.STEP, -1, 1, 0), (trace.AMG_SETUP, -1, -1, 1),
    ]
    assert recs[0].start <= recs[1].start <= recs[2].start <= recs[2].end <= recs[1].end
    assert trace.host_syncs() == 4
    assert {r.name for r in recs if r.step == 0} == {trace.STEP, trace.PC_APPLY, "pc.s"}
    tot = trace.totals()
    assert tot[trace.STEP].count == 2 and tot[trace.STEP].host_syncs == 1
    assert tot["pc.s"].seconds == recs[2].seconds
    names = [e.name for e in prof.events()]
    for name in (trace.STEP, trace.PC_APPLY, "pc.s", trace.AMG_SETUP):
        assert name in names


BANDED = (r"\n===== Banded products: (\d+) diagonal values stored, (\d+\.\d{2})% structural "
          r"zeros; K1 (\d+\.\d{2})% of its values on the scalar path\n")


def _check_banded(groups):
    """The banded line's numbers are ``trace.banded_totals()``'s."""
    band = trace.banded_totals()
    assert band.stored > 0
    assert tuple(groups) == (str(band.stored), f"{band.fill:.2f}", f"{band.k1_scalar_share:.2f}")


def _timing_lines(capfd, problem):
    capfd.readouterr()
    problem.print_timings()
    return capfd.readouterr().out


@pytest.mark.parametrize("name", list(RUNS))
def test_print_timings_reads_the_spans(name, capfd, monkeypatch):
    # coarse size 20 gives the hierarchies levels, and so sparse products,
    # each in row blocks where this host has more than one core
    monkeypatch.setattr(amg, "_BLOCK_WORK", 1)
    problem = _problem(RUNS[name], {"amg coarse size": 20})
    trace.enable()
    its, _ = _steps(problem, 1)
    out = _timing_lines(capfd, problem)
    tot = trace.totals()
    stages = r"\tSolid solver: \d+\.\d{3}s\n" + (
        r"\tFluid solver: \d+\.\d{3}s\n\tPressure solver: \d+\.\d{3}s\n" if name == "3way"
        else r"\tFluid-pressure solver: \d+\.\d{3}s\n")
    want = (r"\n===== Timing Solver: \d+\.\d{3}s\n\n===== Timing preconditioner: "
            r"(\d+\.\d{3})s \((\d+) applications; host seconds issuing each stage inside "
            r"the solve\)\n" + stages + r"\n===== Timing AMG setup: \d+\.\d{3}s \((\d+) "
            r"hierarchies\); Galerkin (\d+\.\d{3})s in (\d+) products, (\d+) in row blocks "
            r"on (\d+) threads\n\n===== Host syncs: (\d+) in 1 steps\n" + BANDED)
    got = re.fullmatch(want, out)
    assert got, out
    pc_s, n_app, n_amg, gal_s, n_gal, n_blocked, threads, syncs, *band = got.groups()
    _check_banded(band)
    assert int(n_app) == its[0] == tot[trace.PC_APPLY].count
    assert pc_s == f"{tot[trace.PC_APPLY].seconds:.3f}"
    assert int(n_amg) == tot[trace.AMG_SETUP].count and int(syncs) == trace.host_syncs()
    assert gal_s == f"{tot[trace.GALERKIN].seconds:.3f}"
    assert int(n_gal) == tot[trace.GALERKIN].count > 0
    assert int(threads) == amg.host_threads()
    assert int(n_blocked) == (int(n_gal) if int(threads) > 1 else 0)
    if name == "3way":
        press = tot["pc.p"].seconds + tot["pc.diff"].seconds
        assert f"\tPressure solver: {press:.3f}s" in out


def test_print_timings_without_spans(capfd):
    problem = _problem(RUNS["2way"])
    _steps(problem, 1)
    out = _timing_lines(capfd, problem)
    got = re.fullmatch(r"\n===== Timing Solver: \d+\.\d{3}s\n" + BANDED, out)
    assert got, out
    _check_banded(got.groups())

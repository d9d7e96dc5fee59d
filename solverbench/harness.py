"""One run of one cell: set-up, the measured window, the traced steps,
the reference's judgement, the result line.

Set-up builds the problem through the port's own driver entry point
(``porotpu_torch.drivers.<driver>.setup``) from the flags and parameters
that the cell's configuration and traffic files give, scales the port's
own surface loads by the seeded factor, runs ``create_solver()`` and one
warm time step.  The window then drives
``Poromechanics.solve_time_step(t)``, the body of the drivers' time loop:
the traffic's fixed number of whole steps, t += dt, with ``seconds`` as a
ceiling.  A traced run then profiles ``TRACE_STEPS`` more steps, with
spans and byte counters wrapped around the port's products: the device's
busy time a step, the rooflines, the idle gaps by host op.  The profiler
stretches each traced step on the host (1.1-2.1x on an H100, 1.3-1.6x
even tracing the device alone: CUPTI's cost a launch) and not the
device's operations, so the idle share sets the traced steps' busy time
against the measured window's time a step.  Each step's solution is
copied to the host as it ends; once the port is freed, the reference
judges the steps (``check``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time

import numpy as np

from . import check, traffic
from .reference.system import System
from .spec import Bench, problem_module

FORBIDDEN = ("jax", "jaxlib", "flax", "porotpu")
SPAN_RHS = "solverbench.get_rhs"
SPAN_SOLVE = "solverbench.solve"
TRACE_STEPS = 2  # profiled steps of a traced run


@dataclasses.dataclass
class Step:
    t: float
    iters: int
    wall_s: float
    converged: bool
    claimed: float  # the field-wise residual the solver reports
    x: object  # the solution on the host, padded layout until judged


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    setup_s: float
    assemble_s: float
    pc_setup_s: float
    window_s: float
    steps: list  # the window's steps
    rhs_s: list  # get_rhs of each window step (traced runs)
    trace: object = None  # trace.Trace of the traced steps
    products: object = None  # trace.Products of the traced steps
    traced_steps: int = 0

    def step_s(self) -> float | None:
        """The window's wall time over its whole steps."""
        return self.window_s / len(self.steps) if self.steps else None

    def device_window_s(self) -> float | None:
        """The traced steps' length at the window's pace: what the busy
        time of the traced steps is set against."""
        step_s = self.step_s()
        return self.traced_steps * step_s if step_s and self.traced_steps else None


class Scaled:
    """A load of the port's, its values times the seeded factor."""

    def __init__(self, load, factor: float):
        self.load = load
        self.factor = float(factor)

    def eval(self, t, x, n=None):
        return self.factor * self.load.eval(t, x, n)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``porotpu_torch`` is not ``porotpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
             bench: Bench | None = None, device: str = "cuda", dtype: str | None = None,
             out=None, err=None) -> int:
    """Run ``workload`` and print its result line; the exit code.

    ``device="cpu"`` skips the look for a card (the harness's tests);
    ``dtype`` replaces the configuration's (the lower-precision control).
    """
    out = out or sys.stdout
    err = err or sys.stderr
    bench = bench or Bench()
    cell = bench.cell(workload)
    import torch

    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"solverbench: {workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
        return 2
    cfg, trf = cell.config, cell.traffic
    prob = problem_module(cfg)
    t0, factors = traffic.draw(trf, seed, prob.LOAD_SLOTS)
    limits = trf.get("limits", cfg["limits"])  # a traffic's own, for another outer solver
    refinements = int(cfg.get("refinements", 0))
    parameters = {**cfg.get("parameters", {}), **trf.get("parameters", {})}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- set-up: the driver's problem, the solver, one warm step ----------
    driver = importlib.import_module("porotpu_torch.drivers." + cfg["driver"])
    argv = ["-N", str(cfg["N"]), "--N-refinements", str(refinements),
            "--petsc-options", cell.path("traffic", trf["options_file"]),
            "--pc-type", trf["pc_type"], "--dtype", dtype or cfg["dtype"], "--device", device,
            *cfg.get("args", []), *trf.get("args", [])]
    a = time.perf_counter()
    problem = driver.setup(argv, dict(parameters, t0=t0))
    for slot, factor in factors.items():
        setattr(problem.assembler, slot, Scaled(getattr(problem.assembler, slot), factor))
    assemble_s = time.perf_counter() - a
    a = time.perf_counter()
    problem.create_solver()
    problem.first_timestep = False
    pc_setup_s = time.perf_counter() - a

    steps = []
    clock = {"t": t0}

    def step():
        clock["t"] += problem.dt
        a = time.perf_counter()
        its = problem.solve_time_step(clock["t"])
        res = problem.last_result
        steps.append(Step(clock["t"], int(its), time.perf_counter() - a, bool(res.converged),
                          float(res.res), problem.sol.cpu()))

    step()
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s (driver setup {assemble_s:.3f}, create_solver "
          f"{pc_setup_s:.3f}, warm step {steps[0].wall_s:.3f}); t0 {t0!r}, load factors "
          f"{factors}", file=err, flush=True)

    # -- the window: the traffic's whole steps, the seconds a ceiling -------
    rhs_s = []
    if traced:
        get_rhs = problem.get_rhs

        def timed_rhs(t):
            sync()
            a = time.perf_counter()
            b = get_rhs(t)
            sync()
            rhs_s.append(time.perf_counter() - a)
            return b

        problem.get_rhs = timed_rhs
    first = len(steps)
    w0 = time.perf_counter()
    for _ in range(int(trf["steps"])):
        step()
        if time.perf_counter() - w0 >= seconds:
            print(f"solverbench: the window reached its ceiling of {seconds} s after "
                  f"{len(steps) - first} of {trf['steps']} steps", file=err, flush=True)
            break
    window_s = time.perf_counter() - w0
    run = Run(setup_s, assemble_s, pc_setup_s, window_s, steps[first:], rhs_s)

    # -- the traced steps ----------------------------------------------------
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as tr

        problem.get_rhs = _spanned(get_rhs, SPAN_RHS)
        problem._solve = _spanned(problem._solve, SPAN_SOLVE)
        run.products = tr.Products()
        restore = tr.install_recorder(run.products)
        try:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                with record_function(tr.WINDOW):
                    for _ in range(TRACE_STEPS):
                        step()
                    sync()
        finally:
            restore()
        run.traced_steps = TRACE_STEPS
        a = time.perf_counter()
        run.trace = tr.reduce_trace(tr.raw_events(prof)) if cuda else None
        del prof
        if run.trace is not None:
            t, p = run.trace, run.products
            print(f"trace: {t.kernels} kernels in {TRACE_STEPS} steps; K1 {t.k1_launches} "
                  f"launches of {p.k1_calls} calls, K2 {t.k2_launches} of {p.k2_calls}, ELL "
                  f"{t.ell_spans} spans of {p.ell_calls} products; busy {t.busy_s:.3f} s; traced "
                  f"{t.window_s:.3f} s against {run.device_window_s():.3f} s at the window's "
                  f"pace; read in {time.perf_counter() - a:.3f} s", file=err, flush=True)

    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    pad_index = problem.pad_index
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    del problem
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference's judgement ------------------------------------------
    a = time.perf_counter()
    for st in steps:
        st.x = st.x.double().numpy()[pad_index]  # each picked step reads the two before it
    system = System(prob, cfg["N"], prob.loads(factors), refinements, cfg.get("parameters"))
    picked = check.sample(len(steps), seed)
    worst, failed = check.judge(system, steps, system.params["solver rtol"],
                                system.params["solver atol"], limits, picked)
    correct = failed == 0 and len(run.steps) > 0 and all(worst[k] <= limits[k] for k in limits)
    print(f"window {window_s:.3f} s, {len(run.steps)} steps; reference {time.perf_counter() - a:.3f} s",
          file=err, flush=True)

    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips if cuda else 0,
           "memory_peak_bytes": mem_peak, "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.device_window_s()
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]} for k in limits}

    bad = forbidden_modules()
    if bad:
        print(f"solverbench: modules loaded that the benchmark may not load: {bad}", file=err)
        return 3
    print(f"steps {len(steps)}, judged {len(picked)}, failed {failed}, unconverged "
          f"{sum(not s.converged for s in steps)}", file=err)
    for k in limits:
        print(f"check {k} {worst[k]!r} limit {limits[k]!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def _spanned(fn, name):
    """``fn`` run under a profiler span ``name``."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped

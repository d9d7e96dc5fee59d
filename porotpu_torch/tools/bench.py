"""bench.py's datapoints on the card (bench.py:run_bench, run_bench_ir).

    python3 -m porotpu_torch.tools.bench

Swelling-3d N=13, one time step's solve, one JSON line a datapoint.
``build_problem`` restores the solver from the cache file of its
configuration in ``.cache/`` when one is there and builds (and saves) it
otherwise, as bench.py:70-114 does; the port's files are named
``torch_bench_<key>.pkl``, never porotpu's ``bench_<key>.pkl``.

- ``datapoint(problem)``: bench.py's datapoint on a problem that has
  taken its first step (``problem.solve()``): three timed solves from zero
  on that step's right-hand side, each scaled by 1 + 1e-6 (i + 1) (CUDA
  events, median), bench.py's true-residual guard on the last (field-wise
  abs < 1e-7 or rel < 1e-5), and the SpMV rate of the block operator
  against the stream peak and the data sheet.  ``run_bench(dtype,
  pc_dtype=)`` builds the bench configuration (``BENCH_OVERRIDES``), takes
  its step and returns its datapoint.  f32 is the headline; bench.py's
  f64 datapoint is ``run_bench("float64", pc_dtype="float32")``, the PC
  built in f32 under CastPC.
- ``run_bench_ir(p32, p64)``: f64 accuracy from f32 solves.  ``refine``
  solves the f32 system for a correction against the f64 true residual
  ``b64 - A64 x``, adds it, and checks the field-wise test in f64 at
  atol 1e-8 / rtol 1e-6, at most 4 passes.  Only A64 and b64 come from the
  f64 problem.

Every time is taken on the card; the functions raise without one, except
``refine``, which runs wherever its problems live.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from ..models.abstract import log
from ..models.benchmarks import BENCH_OVERRIDES, swelling_3d
from ..solvers.convergence import FieldwiseTest
from ..utils import cache
from ..utils.roofline import op_stream_time, padded_values, stream_peak
from .dia_microbench import HBM_BYTES_PER_S

# bench.py:300-310: the true-residual guard of a datapoint, abs or rel
GUARD_ATOL, GUARD_RTOL = 1e-7, 1e-5
# bench.py:136-227: the refinement's f64 tolerances and its passes
IR_ATOL, IR_RTOL, IR_PASSES = 1e-8, 1e-6, 4
# timed solves of a datapoint (median), timed refinements (fastest)
SOLVE_REPS, IR_REPS = 3, 2


def cache_path(dtype="float32", N=13, pc_dtype=None, cache_dir=".cache"):
    """The solver cache file of a bench configuration.  ``impl`` keys the
    port apart from porotpu, and the name's prefix keeps the port from ever
    opening porotpu's pickle (which would import jax)."""
    key = cache.config_key(
        impl="torch", bench="swelling3d", N=N, dt=dtype, pcdt=pc_dtype or dtype,
        overrides=sorted(BENCH_OVERRIDES.items()),
    )
    return os.path.join(cache_dir, f"torch_bench_{key}.pkl")


def build_problem(dtype="float32", N=13, pc_dtype=None, device="cuda", cache_dir=".cache"):
    """The bench configuration at ``dtype``, its PC at ``pc_dtype``, with its
    solver restored from the cache in ``cache_dir`` or built and saved there
    (bench.py:70-114); ``cache_dir`` None builds without a cache."""
    over = dict(BENCH_OVERRIDES, dtype=dtype)
    if pc_dtype is not None and pc_dtype != dtype:
        over["pc dtype"] = pc_dtype
    path = None if cache_dir is None else cache_path(dtype, N, over.get("pc dtype"), cache_dir)
    if path is not None:
        over["solver cache path"] = path
    t0 = time.perf_counter()
    problem = swelling_3d(N, overrides=over, device=device)
    if path is not None and problem.try_load_solver_cache(path):
        log(f"setup (cached): {time.perf_counter() - t0:.1f}s, dofs={problem.W.num_dofs}")
    else:
        problem.create_solver()
        problem.first_timestep = False
        log(f"setup: {time.perf_counter() - t0:.1f}s, dofs={problem.W.num_dofs}")
    return problem


def guard(problem, b, x):
    """(abs, rel) of the field-wise test on the true residual b - A x."""
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, b)
        ea, er = fw.errors(b - problem.A_dev.matvec(x))
    return float(ea), float(er)


def _cuda_seconds(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, out


def spmv_roofline(A, b, peak_gbs):
    """The block operator's product rate: its stored values, the input and
    the output, each moved once a product, over the chained product time;
    against the measured stream peak ``peak_gbs`` and the data sheet."""
    t = op_stream_time(A, b)
    nbytes = (padded_values(A) + 2 * b.numel()) * b.element_size()
    gbps = nbytes / t / 1e9
    return {
        "spmv_ms": t * 1e3, "spmv_gbps": gbps, "stream_peak_gbps": peak_gbs,
        "share_of_measured_peak": gbps / peak_gbs,
        "share_of_data_sheet": gbps * 1e9 / HBM_BYTES_PER_S,
    }


def roofline_line(label, roof):
    return (f"roofline [{label}]: SpMV {roof['spmv_ms']:.4f} ms, {roof['spmv_gbps']:.1f} GB/s = "
            f"{100 * roof['share_of_measured_peak']:.1f}% of the measured stream peak "
            f"{roof['stream_peak_gbps']:.1f} GB/s (chained triad, 256 MB arrays), "
            f"{100 * roof['share_of_data_sheet']:.1f}% of the data sheet's "
            f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s")


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("the bench times the card: it needs a CUDA device")


def datapoint(problem, peak_gbps=None):
    """One datapoint (bench.py:run_bench) on a problem that has taken its
    first step: SOLVE_REPS solves from zero on that step's right-hand side
    scaled by 1 + 1e-6 (i + 1), their median time, the guard on the last
    and the block operator's SpMV roofline against ``peak_gbps`` (the
    stream peak at the problem's dtype, measured here when None).  Raises
    when a solve fails the guard; returns the record."""
    _require_card()
    b = problem.last_rhs
    x0 = torch.zeros_like(b)
    times = []
    for i in range(SOLVE_REPS):
        bi = b * (1.0 + 1e-6 * (i + 1))
        t, res = _cuda_seconds(lambda: problem._solve(bi, x0))
        times.append(t)
    ea, er = guard(problem, bi, res.x)
    dtype = str(problem.dtype).removeprefix("torch.")
    if not (res.converged and (ea < GUARD_ATOL or er < GUARD_RTOL)):
        raise RuntimeError(f"bench [{dtype}]: the solve failed its guard (abs {ea:.3e}, "
                           f"rel {er:.3e})")
    if peak_gbps is None:
        peak_gbps = stream_peak(problem.dtype, device=problem.device)
    pc_dtype = problem.parameters.get("pc dtype")
    return {
        "metric": "swelling3d_step_solve_time", "value": statistics.median(times), "unit": "s",
        "dtype": dtype, **({"pc_dtype": pc_dtype} if pc_dtype else {}),
        "dofs": int(problem.W.num_dofs), "iters": int(res.iters),
        "first_solve_iters": int(problem.iteration_log[0]), "times_s": times,
        "guard_abs": ea, "guard_rel": er, **spmv_roofline(problem.A_dev, b, peak_gbps),
        "device": torch.cuda.get_device_name(problem.device),
    }


def run_bench(dtype="float32", N=13, pc_dtype=None, device="cuda", peak_gbps=None):
    """Build the bench configuration, take its first step and return its
    datapoint."""
    _require_card()
    problem = build_problem(dtype, N, pc_dtype, device)
    problem.solve()
    return datapoint(problem, peak_gbps)


@torch.inference_mode()
def refine(p32, A64, b64, sizes):
    """f32 solves of corrections against the f64 true residual
    (bench.py:run_bench_ir): while the field-wise test fails in f64 and
    fewer than IR_PASSES passes ran, solve p32's system for r = b64 - A64 x
    in f32 from zero and add the correction in f64.  Returns x and a dict
    of the passes, the f32 iterations of each and the final (abs, rel)."""
    fw = FieldwiseTest.from_sizes(sizes, b64)
    x = torch.zeros_like(b64)
    r = b64
    x0 = torch.zeros(b64.shape[0], dtype=torch.float32, device=b64.device)
    ea = er = float("inf")
    iters = []
    while ea > IR_ATOL and er > IR_RTOL and len(iters) < IR_PASSES:
        res = p32._solve(r.to(torch.float32), x0)
        x = x + res.x.to(torch.float64)
        r = b64 - A64.matvec(x)
        ea, er = (float(v) for v in fw.errors(r))
        iters.append(int(res.iters))
    return x, {"passes": len(iters), "f32_iters": iters, "abs": ea, "rel": er}


def run_bench_ir(p32, p64):
    """The f64-IR datapoint on built problems (bench.py:run_bench_ir): p32
    the f32 bench problem, p64 the f64 one, whose operator and right-hand
    side alone are used.  Raises when the refinement misses the f64
    tolerances; returns the record."""
    _require_card()
    b64 = p64.get_rhs(p64.t0 + p64.dt)
    _, first = refine(p32, p64.A_dev, b64, p64.padded_sizes)
    if not (first["abs"] <= IR_ATOL or first["rel"] <= IR_RTOL):
        raise RuntimeError(f"IR did not reach the f64 tolerance: {first}")
    times = []
    for trial in range(IR_REPS):
        bt = b64 * (1.0 + 1e-6 * (trial + 1))
        t, (_, info) = _cuda_seconds(lambda: refine(p32, p64.A_dev, bt, p64.padded_sizes))
        times.append(t)
    return {
        "metric": "swelling3d_step_solve_time", "value": min(times), "unit": "s",
        "dtype": "float64-accuracy (f32 solve + f64 iterative refinement)",
        "passes": info["passes"], "iters": sum(info["f32_iters"]), "times_s": times,
        "first": first, "guard_abs": info["abs"], "guard_rel": info["rel"],
        "dofs": int(p64.W.num_dofs), "device": torch.cuda.get_device_name(p64.device),
    }


def main():
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    peaks = {dt: stream_peak(dt) for dt in (torch.float32, torch.float64)}
    print(json.dumps(run_bench("float32", peak_gbps=peaks[torch.float32])), flush=True)
    print(json.dumps(run_bench("float64", pc_dtype="float32", peak_gbps=peaks[torch.float64])),
          flush=True)
    p32 = build_problem("float32")
    p64 = build_problem("float64", pc_dtype="float32")
    print(json.dumps(run_bench_ir(p32, p64)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

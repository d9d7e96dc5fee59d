#!/usr/bin/env python3
"""Where one swelling-3d solve of the PyTorch/CUDA port spends its time.

    python3 tools/profile_torch_solve.py [float32|float64]
    python3 tools/profile_torch_solve.py swelling -N 80 --petsc-options petsc-options-inexact

Builds the bench configuration (bench.py overrides, f32 unless float64
is named: then every transpose runs K2) on cuda:0, or, when the first
argument names a driver of ``porotpu_torch.drivers`` (footing, swelling,
swelling_3d), the problem that driver builds from the rest of the
command line (f64, the first time step's right-hand side); then it
solves once to warm up, then profiles one solve with torch.profiler and
prints: wall time, the summed device time of all kernels and its share
of the wall time (the rest is the device waiting on the host), and the
kernels and operators that take the most device time, the device time
and launches of K1 and K2, and the solve's launches by operator (kernel,
dtype, nd, nrows; ``dia_kernel.LAUNCHES``).  Needs a CUDA card.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(e):
    # the attribute was renamed from self_cuda_time_total in newer torch
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def main(what="float32", *argv):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
    from porotpu_torch.ops import dia_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if what in ("footing", "swelling", "swelling_3d"):
        import importlib

        driver = importlib.import_module("porotpu_torch.drivers." + what)
        problem = driver.setup(list(argv))
        label = f"{what} {' '.join(argv)}, {str(problem.dtype).removeprefix('torch.')}"
    else:
        problem = swelling_3d(13, overrides=dict(BENCH_OVERRIDES, dtype=what), device=dev)
        label = what
    problem.create_solver()
    problem.first_timestep = False
    b = problem.get_rhs(problem.t0 + problem.dt)
    x0 = torch.zeros_like(b)
    problem._solve(b, x0)
    torch.cuda.synchronize()

    dia_kernel.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = problem._solve(b, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [
        e for e in events
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    dev_us = sum(_device_us(e) for e in kernels)
    print(f"{torch.cuda.get_device_name(0)}, {label}: one solve, {res.iters} iterations, "
          f"wall {wall * 1e3:.3f} ms, device busy {dev_us / 1e3:.3f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall), {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:12]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    for name in ("dia_mv_kernel", "dia_rmv_kernel"):
        mine = [e for e in kernels if name in e.key]
        us = sum(_device_us(e) for e in mine)
        n = sum(e.count for e in mine)
        print(f"{name}: {us / 1e3:.3f} ms of device time in {n} launches "
              f"({100 * us / max(dev_us, 1e-9):.1f}% of device busy)")
    print("launches by operator (kernel dtype nd nrows: launches):")
    for (kernel, dt, nd, nrows), n in sorted(dia_kernel.LAUNCHES.items(),
                                             key=lambda kv: -kv[1] * kv[0][2] * kv[0][3]):
        print(f"  {kernel} {dt} {nd} {nrows}: {n}")
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

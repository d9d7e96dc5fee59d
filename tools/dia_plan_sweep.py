#!/usr/bin/env python3
"""K1 and K2 under the launch plans around the one ``launch_plan`` picks.

    python3 tools/dia_plan_sweep.py

Builds swelling-3d N=13 with the bench overrides (f32) on cuda:0 for the
shapes and offsets of its operators (chip_smoke.py: ``k1_sets``,
``k2_sets``).  For each set, in f32 and f64, it launches K1 (forward
sets) or K2 (transpose sets) with 4 and 8 warps a block and clusters of
1, 2, 4 and 8 blocks.  Each plan is first
checked against the plain version (f32 1e-5, f64 1e-12 of max|y|), then
timed back to back (warm L2) and with the L2 flushed before each launch
(cold), CUDA events, the mean of 50 launches.  One line a set and plan; ``*`` marks the plan that
``launch_plan`` picks, and the share is that of the bytes bound in the
cold time.  Needs a CUDA card.
"""

import dataclasses
import itertools
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 50


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dia_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.tools import dia_microbench as mb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    problem = swelling_3d(13, overrides=dict(BENCH_OVERRIDES), device=dev)
    problem._build_operators()
    sets = [("dia_mv", k, v) for k, v in chip_smoke.k1_sets(problem).items()]
    sets += [("dia_rmv", k, v) for k, v in chip_smoke.k2_sets(problem).items()]
    del problem
    lib = dia_kernel._load()
    rng = np.random.default_rng(0)

    for kernel, name, (shape, offs, n) in sets:
        nd, nrows = shape
        n_out, n_in = (nrows, n) if kernel == "dia_mv" else (n, nrows)
        print(f"{kernel} {name}: nd={nd} nrows={nrows} n_in={n_in} n_out={n_out}, "
              f"offsets {min(offs)}..{max(offs)}", flush=True)
        offs_dev = torch.tensor(offs, dtype=torch.int32, device=dev)
        data64, x64 = rng.normal(size=shape), rng.normal(size=n_in)
        entries = mb.band_entries(offs, nrows, n)
        for tag, dtype, tol in (("f32", torch.float32, 1e-5), ("f64", torch.float64, 1e-12)):
            data = torch.as_tensor(data64, dtype=dtype, device=dev)
            x = torch.as_tensor(x64, dtype=dtype, device=dev)
            if kernel == "dia_mv":
                ref = dia_kernel.dia_mv_ref(data, offs, x, nrows)
                fn = getattr(lib, f"porotpu_dia_mv_{tag}")
            else:
                ref = dia_kernel.dia_rmv_ref(data, offs, x, n)
                fn = getattr(lib, f"porotpu_dia_rmv_{tag}")
            picked = dia_kernel.launch_plan(nd, n_out, n_in, dtype)
            nbytes = (entries + n_in + n_out) * data.element_size()
            b_ms, _ = mb.bound(nbytes, 2 * entries, dtype)
            tile = picked.tile
            for warps, cluster in itertools.product((4, 8), (1, 2, 4, 8)):
                plan = dataclasses.replace(
                    picked, warps=warps, cluster=cluster, blocks=-(-n_out // tile) * cluster,
                    smem_bytes=dia_kernel.smem_bytes(warps, tile, data.element_size()))
                y = torch.empty(n_out, dtype=dtype, device=dev)

                def run(plan=plan, y=y):
                    return dia_kernel._launch_planned(kernel, fn, data, offs_dev, x, n, y, plan)

                run()
                torch.cuda.synchronize()
                err = ((y - ref).abs().max() / ref.abs().max()).item()
                if not err <= tol:
                    raise RuntimeError(f"{kernel} {name} {tag} {plan}: error {err:.2e}")
                warm, cold = mb.cuda_ms(run, REPS), mb.cold_ms(run, REPS)
                mark = "*" if plan == picked else " "
                print(f" {mark} {tag} tile={tile} warps={warps} cluster={cluster} "
                      f"blocks={plan.blocks:4d}: warm {warm:.4f} ms, cold {cold:.4f} ms "
                      f"({100 * b_ms / cold:.1f}% of {b_ms:.4f}), err {err:.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

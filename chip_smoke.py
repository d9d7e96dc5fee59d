#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (porotpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), nvcc and torch
   versions, and builds every kernel (porotpu_torch/csrc/*.cu, one nvcc
   per source, all together) from the checkout, printing the build time
   and ptxas's register report.
2. Main path, K1: swelling-3d N=13 with the bench.py overrides (120,842
   dofs, pad multiple 128, f32, loads-only), one time step through
   ``problem.solve()``: FGMRES + the 2-way block preconditioner with AMG.
   The dispatch counts are reset just before and read just after; the
   run fails unless K1 launched, K2 did not (f32 transposes run K1 on
   dataT) and no banded product took a plain PyTorch version.  The
   launches of the step are also printed by operator (kernel, dtype, nd,
   nrows).  Then three timed solves on distinct right-hand sides (CUDA
   events, median) and bench.py's true-residual field-wise guard.
3. K2's path: the same configuration in f64, where no operator stores
   dataT and every transpose (each restriction P^T r, each Transposed
   coupling block) runs K2.  One step with the counts reset around it
   (K2 and K1 launched, no plain product), three timed solves and the
   guard.
4. K1 against its plain version on the offset sets of the built N=13
   operators (the 233-band level-0 A, the 681-band level-1 A, an embedded
   coupling block and a restriction through dataT on negated offsets), in
   f32 (max error <= 1e-5 of max|y|) and f64 (<= 1e-12), each launched
   twice and held bitwise equal; beside each time, the bound and cuSPARSE
   on the same matrix.
5. K2 against its plain version on the transposed products of the built
   N=13 f32 and f64 operators (each banded prolongator of the solid AMG
   and the widest Transposed coupling block), same tolerances and the same
   repeat check; beside each time, K1 on a dataT built on the card from
   the same data, the bound and cuSPARSE.
   Every kernel and cuSPARSE is timed two ways (CUDA events, mean per
   launch): back to back, which keeps a set under 50 MB warm in the L2 as
   the solve's repeated products find it, and with the L2 flushed before
   each launch (cold).  The bound share is taken from the cold time, and
   each set prints its launches in the step of its path and launches x
   (cold time - bound).
6. A small input against a reference: swelling-3d N=3 in f64 on the card
   (K2 included) and on the CPU (plain versions) must take the same
   iterations and agree to 1e-10.
7. K3's path, its entry point porotpu_torch/tools/dia_microbench.py (the
   counts reset around it): K3 against the numpy reference, its plain
   version and K1 to 1e-5, and its times beside K1's and cuSPARSE's.
8. The reference drivers' path in f64, through the port's driver
   functions (``porotpu_torch.drivers.*.setup`` with the command line a
   user would give, then ``solve()`` and ``print_timings()``), each run
   with the counts reset just before the solve and read just after:
   swelling N=80 with petsc-options-inexact (110,245 dofs, porotpu's 16
   iterations at t=0.1, output/SUMMARY.md), footing N=40 with
   petsc-options-inexact and pc type undrained (126,691 dofs, 35
   iterations), swelling N=20 with petsc-options-exact (dense-LU inner
   solves and fp block, 8 iterations).  Each must give its count, pass
   the true-residual field-wise guard at its own tolerances, launch K1
   and take no plain version.  The swelling runs must launch K2; footing
   must hold no banded transpose (its prolongators and coupling blocks
   store ELL, as porotpu's) and launch no K2.  Printed: host setup, solve
   time, peak memory, launches by operator and per iteration, the
   launches that took the masked scalar path (pad multiple 1 leaves
   lengths that are not whole 16-byte chunks), the ELL products and the
   heaviest ELL product of each kind timed.  Then the heaviest K1 and K2
   sets of each run (launches x diagonals x rows), on the path (vector or
   masked scalar) the run took them, and its heaviest scalar-path sets
   are held against the plain version at 1e-12 on random data at their
   shapes and offsets and timed cold against their bound and cuSPARSE.
9. The drivers' defaults (full-residual RHS, cg+amg inner solves):
   swelling N=6 over three steps on the card and with ``--device cpu``
   must take the same iterations at every step and agree to 1e-10.

Any failed check raises and the script exits non-zero.  It also exits
non-zero without a CUDA device, and fails if jax or any module of porotpu
was imported.  The last two stdout lines are the JSON kernel record and
{"ok": true, "device": {...}}.
"""

import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 8: label, driver, command line, dofs, porotpu's f64 iterations at
# t=0.1 (output/SUMMARY.md; dofs from output/robustness-2d-*.out) and
# whether the run holds banded transposes (then K2 must launch; else none
# may exist and K2 must not launch)
DRIVER_RUNS = (
    ("swelling_inexact", "swelling",
     ["-N", "80", "--petsc-options", "petsc-options-inexact"], 110245, [16], True),
    ("footing_inexact", "footing",
     ["-N", "40", "--petsc-options", "petsc-options-inexact", "--pc-type", "undrained"],
     126691, [35], False),
    ("swelling_exact", "swelling",
     ["-N", "20", "--petsc-options", "petsc-options-exact"], 7165, [8], True),
)
# phase 8 holds, from each run, this many of its heaviest K1 sets, K2 sets
# and scalar-path sets against the plain version
HELD_SETS = 4
# phase 9: the drivers' defaults over three steps
DEFAULTS_RUN = ["-N", "6", "--time-final", "0.3"]


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def check_imports():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "porotpu"))
    check(not bad, f"modules of jax or porotpu were imported: {bad[:5]}")


def _banded(P):
    """The DIA a prolongator's products run on (a Transposed one's inner)."""
    return P.inner if type(P).__name__ == "Transposed" else P


def k1_sets(problem):
    """The forward products of a built N=13 problem K1 is checked on:
    name -> (shape of data, offsets, length of the input).  The level-0
    and level-1 A, the level-0 restriction through dataT (f32) and the
    widest rectangular coupling block of the outer operator."""
    l0, l1 = problem.pc.solve_s.mods["amg"].levels[:2]
    sets = {
        "L0_A": (tuple(l0.A.data.shape), l0.A.offsets, l0.A.ne),
        "L1_A": (tuple(l1.A.data.shape), l1.A.offsets, l1.A.ne),
    }
    P = _banded(l0.P)
    check(P.dataT is not None, "f32 level-0 prolongator stores no dataT")
    sets["P_restrict_dataT"] = (tuple(P.dataT.shape), tuple(-o for o in P.offsets), P.nrows)
    rect = [
        D for D in problem.A_dev.modules()
        if type(D).__name__ == "DIA" and (D.col_emb is not None or D.ne != D.nrows)
    ]
    check(rect, "no rectangular coupling block in the outer operator")
    D = max(rect, key=lambda d: (d.col_emb is not None, d.ne != d.nrows, len(d.offsets)))
    sets["coupling"] = (tuple(D.data.shape), D.offsets, D.ne)
    return sets


def k2_sets(problem):
    """The transposed products of a built N=13 problem K2 is checked on:
    name -> (shape of data, offsets, length of the output).  Each banded
    prolongator of the solid AMG (the coarse levels' are dense) and the
    widest Transposed block (ne != nrows first, where there is one)."""
    sets = {}
    for k, lv in enumerate(problem.pc.solve_s.mods["amg"].levels):
        P = _banded(lv.P)
        if type(P).__name__ == "DIA":
            sets[f"L{k}_P"] = (tuple(P.data.shape), P.offsets, P.ne)
        else:
            print(f"solid AMG level {k}: P is {type(P).__name__}, not banded")
    check("L0_P" in sets, "the level-0 prolongator is not banded")
    mods = list(problem.A_dev.modules()) + list(problem.pc.modules())
    tr = [m.inner for m in mods
          if type(m).__name__ == "Transposed" and type(m.inner).__name__ == "DIA"]
    check(tr, "no Transposed banded block in the operator or the PC")
    D = max(tr, key=lambda d: (d.ne != d.nrows, len(d.offsets)))
    sets["transposed_block"] = (tuple(D.data.shape), D.offsets, D.ne)
    return sets


def path_run(problem, dev, torch, dia_kernel, FieldwiseTest):
    """One step through ``problem.solve()`` (host setup included) with the
    dispatch counts reset just before and read just after, then three timed
    solves on distinct right-hand sides and the true-residual guard.
    Returns the dispatch counts of the step, and its launches by operator."""
    torch.cuda.reset_peak_memory_stats(dev)
    dia_kernel.reset_counts()
    iterations = problem.solve()
    counts = dict(dia_kernel.COUNTS)
    launches = dict(dia_kernel.LAUNCHES)
    res = problem.last_result
    hist = [float(h) for h in res.history[: res.iters + 1]]
    print(f"host setup: {problem.t_setup:.2f} s, first solve: {problem.t_solve_total:.4f} s")
    print(f"iterations={iterations} converged={res.converged} residual={res.res:.4e}")
    print("residual history:", " ".join(f"{h:.4e}" for h in hist))
    print("dispatch counts in the solve: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    print("launches by operator (kernel dtype nd nrows: launches):")
    # heaviest first: launches x diagonals x rows
    for (kernel, dt, nd, nrows), n in sorted(launches.items(),
                                             key=lambda kv: -kv[1] * kv[0][2] * kv[0][3]):
        print(f"  {kernel} {dt} {nd} {nrows}: {n}")
    sys.stdout.flush()
    check(res.converged, "the solve did not converge")

    b = problem.get_rhs(problem.t)
    x0 = torch.zeros_like(b)
    solve_ms, bs = [], []
    for i in range(3):
        bi = b * (1.0 + 1e-6 * (i + 1))
        bs.append(bi)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r_i = problem._solve(bi, x0)
        end.record()
        torch.cuda.synchronize()
        solve_ms.append(start.elapsed_time(end))
    solve_s = statistics.median(solve_ms) / 1e3
    print("timed solves (ms): " + ", ".join(f"{t:.3f}" for t in solve_ms)
          + f"; median {solve_s:.5f} s, {r_i.iters} iterations")
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, bs[-1])
        ea, er = (float(v) for v in fw.errors(bs[-1] - problem.A_dev.matvec(r_i.x)))
    print(f"true residual fieldwise: abs={ea:.3e} rel={er:.3e}")
    check(r_i.converged and (ea < 1e-7 or er < 1e-5), "true-residual guard failed")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak device memory allocated: {peak / 2**20:.1f} MiB", flush=True)
    if iterations != [9]:
        print(f"NOTE: {iterations[0]} iterations, the porotpu oracle (BENCH_r05) took 9")
    return counts, launches


def _argv(argv):
    """A command line with the options file as a path into the checkout."""
    return [os.path.join(ROOT, a) if a.startswith("petsc-options") else a for a in argv]


def operators(problem):
    """One walk over a problem's device operators (A_dev, the PC, H_dev):
    type name -> modules, for DIA, ELL, Transposed and AMGLevel."""
    ops = {"DIA": [], "ELL": [], "Transposed": [], "AMGLevel": []}
    for root in (problem.A_dev, problem.pc, problem.H_dev):
        for m in root.modules() if root is not None else ():
            ops.get(type(m).__name__, []).append(m)
    return ops


def banded_transposes(ops):
    """The banded operators whose transpose product a solve takes: the DIA
    inside a Transposed block, and a DIA prolongator (restriction P^T r).
    In f64 no dataT is stored, so each of these runs K2."""
    cands = [m.inner for m in ops["Transposed"]] + [m.P for m in ops["AMGLevel"]]
    return [m for m in cands if type(m).__name__ == "DIA"]


def time_heaviest_ell(ops, ell, dev, torch, mb):
    """Cold and warm time of the ELL product of each kind (gather matvec,
    index_add rmatvec) that took the most of a solve's ELL work (products
    x rows x width), beside the bytes it must move."""
    ells = {(str(m.data.dtype).removeprefix("torch."), *m.data.shape): m for m in ops["ELL"]}
    for product in ("matvec", "rmatvec"):
        keys = [k for k in ell if k[0] == product and k[1:] in ells]
        if not keys:
            continue
        key = max(keys, key=lambda k: ell[k] * k[2] * k[3])
        op = ells[key[1:]]
        n, width = op.data.shape
        n_in, n_out = (op.ncols, n) if product == "matvec" else (n, op.ncols)
        x = torch.randn(n_in, dtype=op.data.dtype, device=dev)
        nbytes = (n * width * (op.data.element_size() + op.cols.element_size())
                  + (n_in + n_out) * op.data.element_size())
        b_ms, b_by = mb.bound(nbytes, 2 * n * width, op.data.dtype)
        run = getattr(op, product)
        ms, warm = mb.cold_ms(lambda: run(x), 30), mb.cuda_ms(lambda: run(x), 50)
        print(f"heaviest ELL {product} ({n} rows x {width}, {ell[key]} products in the solve): "
              f"cold {ms:.4f} ms ({100 * b_ms / ms:.1f}% of the {b_by} bound {b_ms:.4f} ms), "
              f"warm {warm:.4f} ms; x (cold - bound) over the solve "
              f"{ell[key] * (ms - b_ms):.1f} ms", flush=True)


def driver_run(label, drv, argv, dofs, oracle, k2, dev, torch, dia_kernel, ell_products,
               FieldwiseTest, mb):
    """One driver run on the card: ``setup(argv)``, then ``solve()`` with the
    counts reset just before and read just after, then ``print_timings()``.
    Checks the dofs, the true-residual guard at the problem's own
    tolerances, K1 > 0, no plain product, and K2 as the run expects
    (``k2``: launched, or no banded transpose and no launch).  Returns the
    run's numbers and the sets to hold against the plain version: a list
    of ((kernel, dtype, nd, nrows), offsets, ne, vector path, launches).
    The iteration count is returned, not checked, so that every run
    reports before a count against porotpu's fails the script."""
    import numpy as np

    print(f"-- {label}: python -m {drv.__name__} {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    problem = drv.setup(_argv(argv))
    t_problem = time.perf_counter() - t0
    check(problem.device.type == "cuda" and problem.dtype == torch.float64,
          f"{label}: runs on {problem.device} in {problem.dtype}, not on the card in f64")
    n = problem.W.num_dofs
    check(n == dofs, f"{label}: {n} dofs, porotpu's run had {dofs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia_kernel.reset_counts()
    ell_products.clear()
    iterations = problem.solve()
    counts = dict(dia_kernel.COUNTS)
    launches = dict(dia_kernel.LAUNCHES)
    scalar = dict(dia_kernel.SCALAR_LAUNCHES)
    ell = dict(ell_products)
    peak = torch.cuda.max_memory_allocated(dev)
    res = problem.last_result
    hist = [float(h) for h in res.history[: res.iters + 1]]
    its = sum(iterations)
    k12 = counts["dia_mv"] + counts["dia_rmv"]
    n_scalar = sum(scalar.values())
    print(f"dofs={n} padded sizes={problem.padded_sizes}; problem built in {t_problem:.2f} s, "
          f"host setup {problem.t_setup:.2f} s, solve {problem.t_solve_total:.4f} s; "
          f"peak device memory {peak / 2**20:.1f} MiB")
    print(f"iterations={iterations} (porotpu {oracle}) converged={res.converged} "
          f"residual={res.res:.4e}")
    print("residual history:", " ".join(f"{h:.4e}" for h in hist))
    print("dispatch counts in the solve: " + ", ".join(f"{k}={v}" for k, v in counts.items())
          + f"; K1+K2 launches an iteration {k12 / max(its, 1):.1f}")
    print(f"scalar-path launches: {n_scalar} of {k12} ({100 * n_scalar / max(k12, 1):.1f}%); "
          f"ELL products: {sum(ell.values())}")
    print("launches by operator (kernel dtype nd nrows: launches, of them scalar path):")
    for key, k in sorted(launches.items(), key=lambda kv: -kv[1] * kv[0][2] * kv[0][3]):
        print(f"  {' '.join(map(str, key))}: {k}, {scalar.get(key, 0)}")
    for key, k in sorted(ell.items()):
        print(f"  ELL {' '.join(map(str, key))}: {k}")
    sys.stdout.flush()
    problem.print_timings()
    sys.stdout.flush()

    b = problem.last_rhs
    atol = float(problem.parameters["solver atol"])
    rtol = float(problem.parameters["solver rtol"])
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, b)
        ea, er = (float(v) for v in fw.errors(b - problem.A_dev.matvec(problem.sol)))
    print(f"true residual fieldwise: abs={ea:.3e} rel={er:.3e} (atol {atol:g}, rtol {rtol:g})",
          flush=True)
    check(res.converged, f"{label}: the solve did not converge")
    check(ea < atol or er < rtol, f"{label}: true-residual guard failed")
    check(np.isfinite(problem.sol.cpu().numpy()).all(), f"{label}: non-finite solution")
    check(counts["dia_mv"] > 0, f"{label}: K1 was never launched")
    check(counts["plain"] == 0, f"{label}: {counts['plain']} banded products took a plain version")
    ops = operators(problem)
    transposes = banded_transposes(ops)
    print(f"banded operators applied transposed (K2's): {len(transposes)}; "
          f"DIA {len(ops['DIA'])}, ELL {len(ops['ELL'])}, Transposed {len(ops['Transposed'])}")
    if k2:
        check(counts["dia_rmv"] > 0, f"{label}: K2 was never launched")
    else:
        check(not transposes, f"{label}: {len(transposes)} banded transposes, none expected")
        check(counts["dia_rmv"] == 0, f"{label}: K2 launched with no banded transpose")
    time_heaviest_ell(ops, ell, dev, torch, mb)

    # the sets to hold: the heaviest of each kernel over all launches, and
    # the heaviest scalar-path sets, each on the path the run took it
    dias = {tuple(m.data.shape): (m.offsets, m.ne) for m in ops["DIA"]}
    missing = sorted(k for k in launches if k[2:] not in dias)
    if missing:
        print(f"NOTE: {len(missing)} launched sets have no operator of their shape here: "
              f"{missing[:4]}")
    weight = lambda counter: lambda k: -counter[k] * k[2] * k[3]  # noqa: E731
    found = [k for k in launches if k[2:] in dias]
    chosen = []
    for kernel in ("dia_mv", "dia_rmv"):
        chosen += sorted((k for k in found if k[0] == kernel), key=weight(launches))[:HELD_SETS]
    chosen += sorted((k for k in found if k in scalar), key=weight(scalar))[:HELD_SETS]
    held = []
    for key in dict.fromkeys(chosen):
        n_vec = launches[key] - scalar.get(key, 0)
        held += [(key, *dias[key[2:]], vec, n_path)
                 for vec, n_path in ((True, n_vec), (False, scalar.get(key, 0))) if n_path]
    share = sum(launches[k] for k in dict.fromkeys(chosen)) / max(k12, 1)
    print(f"sets held against the plain version: {len(held)}, "
          f"{100 * share:.1f}% of the run's K1+K2 launches", flush=True)
    out = dict(iterations=iterations, launches=launches, scalar=scalar, counts=counts, held=held,
               solve_s=problem.t_solve_total, setup_s=problem.t_setup, peak_mib=peak / 2**20)
    out["problem"] = problem
    return out


def hold_set(key, offs, ne, vec, dev, torch, dia_kernel, mb, rng):
    """Hold a driver run's set (kernel, dtype, nd, nrows; its offsets and
    ne) against its plain version on random data at its shape, on the path
    the run took it: the vector path on an aligned input, the masked scalar
    path on an input misaligned by one value where the set's lengths are
    whole chunks.  Checks that the launch took that path, then times it
    cold and warm beside its bound and cuSPARSE."""
    kernel, dt, nd, nrows = key
    dtype = getattr(torch, dt)
    n_in, n_out = (ne, nrows) if kernel == "dia_mv" else (nrows, ne)
    plan = dia_kernel.launch_plan(nd, n_out, n_in, dtype)
    check(plan.vec or not vec, f"{key}: the vector path was launched, the plan has none")
    data = torch.as_tensor(rng.normal(size=(nd, nrows)), dtype=dtype, device=dev)
    buf = torch.as_tensor(rng.normal(size=n_in + 1), dtype=dtype, device=dev)
    x = buf[1:] if plan.vec and not vec else buf[:n_in]
    offs_dev = torch.tensor(offs, dtype=torch.int32, device=dev)
    if kernel == "dia_mv":
        run = lambda: dia_kernel.dia_mv(data, offs_dev, x)  # noqa: E731
        ref = dia_kernel.dia_mv_ref(data, offs, x, nrows)
        A = mb.banded_csr(data, offs, ne)
    else:
        run = lambda: dia_kernel.dia_rmv(data, offs_dev, x, ne)  # noqa: E731
        ref = dia_kernel.dia_rmv_ref(data, offs, x, ne)
        A = mb.banded_csr(data, offs, ne, transpose=True)
    n_scalar = dia_kernel.SCALAR_LAUNCHES[key]
    y = run()
    check((dia_kernel.SCALAR_LAUNCHES[key] == n_scalar) == vec,
          f"{key}: the launch did not take the {'vector' if vec else 'scalar'} path")
    rel = ((y - ref).abs().max() / ref.abs().max()).item()
    path = "vector path" if vec else (
        "scalar path, misaligned input" if plan.vec else "scalar path, lengths not whole chunks")
    check(rel <= 1e-12, f"{key} disagrees with its plain version on the {path} ({rel:.2e})")
    xc = x.contiguous()
    entries = mb.band_entries(offs, nrows, ne)
    b_ms, b_by = mb.bound((entries + n_in + n_out) * dtype.itemsize, 2 * entries, dtype)
    ms, warm = mb.cold_ms(run, 30), mb.cuda_ms(run, 50)
    lib, lib_warm = mb.cold_ms(lambda: A @ xc, 30), mb.cuda_ms(lambda: A @ xc, 50)
    print(f"  {kernel} {dt} nd={nd} nrows={nrows} ne={ne} ({path}, cluster {plan.cluster}): "
          f"err {rel:.2e}; cold {ms:.4f} ms ({100 * b_ms / ms:.1f}% of the {b_by} bound "
          f"{b_ms:.4f} ms), warm {warm:.4f} ms; cuSPARSE cold {lib:.4f} warm {lib_warm:.4f} ms",
          flush=True)
    return ms


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 2

    from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.ops.dia import transpose_layout
    from porotpu_torch.solvers.convergence import FieldwiseTest
    from porotpu_torch.tools import dia_microbench as mb

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full-f32 products (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card, toolchain, kernel build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run(
        [dia_kernel._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()
    print("nvcc:", nvcc[-2] if len(nvcc) > 1 else nvcc[-1])
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"device {torch.cuda.get_device_name(0)}")
    build_s, ptxas = dia_kernel.build()
    print(f"kernel build: {build_s:.2f} s ({dia_kernel.LIBRARY}, "
          f"{len(dia_kernel.SOURCES)} sources)")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info")[-1].strip(" :"))
    sys.stdout.flush()

    # -- 2. main path, K1: swelling-3d N=13 f32, one step ------------------
    f32 = swelling_3d(13, overrides=dict(BENCH_OVERRIDES), device=dev)
    dofs, padded = f32.W.num_dofs, f32.padded_sizes
    print(f"dofs={dofs} padded sizes={padded}")
    check(dofs == 120842, f"dofs {dofs} != 120842")
    check(padded == (59136, 59136, 2816), f"padded sizes {padded}")
    counts32, launches32 = path_run(f32, dev, torch, dia_kernel, FieldwiseTest)
    check(counts32["dia_mv"] > 0, "K1 was never launched on the main path")
    check(counts32["dia_rmv"] == 0, "K2 ran on the f32 path, whose transposes read dataT")
    check(counts32["plain"] == 0, f"{counts32['plain']} banded products took a plain version")
    sets1 = k1_sets(f32)
    sets2 = {("f32", k): v for k, v in k2_sets(f32).items()}
    del f32  # the problem's solve closure holds a cycle: collect it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory allocated before the f64 path: "
          f"{torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB")

    # -- 3. K2's path: swelling-3d N=13 f64, one step -----------------------
    print("-- f64 (K2 path)", flush=True)
    f64 = swelling_3d(13, overrides=dict(BENCH_OVERRIDES, dtype="float64"), device=dev)
    counts64, launches64 = path_run(f64, dev, torch, dia_kernel, FieldwiseTest)
    check(counts64["dia_rmv"] > 0, "K2 was never launched on the f64 path")
    check(counts64["dia_mv"] > 0, "K1 was never launched on the f64 path")
    check(counts64["plain"] == 0, f"{counts64['plain']} banded products took a plain version")
    check(not any(type(m).__name__ == "DIA" and m.dataT is not None
                  for m in list(f64.A_dev.modules()) + list(f64.pc.modules())),
          "an f64 operator stores dataT")
    sets2.update({("f64", k): v for k, v in k2_sets(f64).items()})
    del f64
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    dtypes = {"f32": (torch.float32, 1e-5), "f64": (torch.float64, 1e-12)}
    path_launches = {"f32": launches32, "f64": launches64}
    record = {}  # (kernel, set, dtype) -> dict of numbers
    max_abs = {"dia_mv": 0.0, "dia_rmv": 0.0}

    def compare(kernel, key, run, ref, tol):
        """Launch twice: bitwise equal, and within tol of max|ref|."""
        y, y2 = run(), run()
        torch.cuda.synchronize()
        check(torch.equal(y, y2), f"{kernel} {key}: two launches differ")
        abs_err = (y - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        check(rel <= tol, f"{kernel} {key} disagrees with its plain version ({rel:.2e})")
        max_abs[kernel] = max(max_abs[kernel], abs_err)
        return y, rel

    def timing(kernel, name, tag, run, lib, plain, entries, n_in, n_out, dtype, nd, nrows):
        """Warm and cold times of the kernel and cuSPARSE, the plain time,
        the bound and the set's launches in its path's step."""
        nbytes = (entries + n_in + n_out) * dtype.itemsize
        b_ms, b_by = mb.bound(nbytes, 2 * entries, dtype)
        key = (kernel, str(dtype).removeprefix("torch."), nd, nrows)
        rec = dict(
            warm_ms=mb.cuda_ms(run, 50), ms=mb.cold_ms(run, 30),
            library_warm_ms=mb.cuda_ms(lib, 50), library_ms=mb.cold_ms(lib, 30),
            plain_ms=mb.cuda_ms(plain, 10), bound_ms=b_ms, bound_by=b_by, nbytes=nbytes,
            launches=path_launches[tag].get(key, 0),
        )
        record[kernel, name, tag] = rec
        return rec

    def report(label, rec, rel, extra=""):
        print(f"{label}: err {rel:.2e}; cold {rec['ms']:.4f} ms "
              f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of the {rec['bound_by']} bound "
              f"{rec['bound_ms']:.4f} ms, {rec['nbytes'] / 1e6:.1f} MB), "
              f"warm {rec['warm_ms']:.4f} ms; "
              f"cuSPARSE cold {rec['library_ms']:.4f} warm {rec['library_warm_ms']:.4f} ms; "
              f"plain {rec['plain_ms']:.4f} ms; {rec['launches']} launches in the step, "
              f"x (cold - bound) = {rec['launches'] * (rec['ms'] - rec['bound_ms']):.3f} ms"
              + extra, flush=True)

    # -- 4. K1 against its plain version on the N=13 offset sets -------------
    for name, (shape, offs, n_in) in sets1.items():
        nd, nrows = shape
        data64 = rng.normal(size=shape)
        x64 = rng.normal(size=n_in)
        offs_dev = torch.tensor(offs, dtype=torch.int32, device=dev)
        entries = mb.band_entries(offs, nrows, n_in)
        for tag, (dtype, tol) in dtypes.items():
            data = torch.as_tensor(data64, dtype=dtype, device=dev)
            x = torch.as_tensor(x64, dtype=dtype, device=dev)
            plan = dia_kernel.launch_plan(nd, nrows, n_in, dtype)
            run = lambda: dia_kernel.dia_mv(data, offs_dev, x)  # noqa: E731
            y, rel = compare("dia_mv", (name, tag), run,
                             dia_kernel.dia_mv_ref(data, offs, x, nrows), tol)
            A = mb.banded_csr(data, offs, n_in)
            rel_lib = ((A @ x - y).abs().max() / y.abs().max()).item()
            rec = timing("dia_mv", name, tag, run, lambda: A @ x,
                         lambda: dia_kernel.dia_mv_ref(data, offs, x, nrows),
                         entries, n_in, nrows, dtype, nd, nrows)
            report(f"K1 {name} nd={nd} nrows={nrows} n_in={n_in} offsets {min(offs)}..{max(offs)} "
                   f"{tag} (tile {plan.tile}, warps {plan.warps}, cluster {plan.cluster})",
                   rec, rel, f"; cuSPARSE err {rel_lib:.1e}")
            if (name, tag) == ("L0_A", "f32"):
                # the wrapper's host time a call, with the device kept busy
                torch.cuda.synchronize()
                torch.cuda._sleep(mb.SLEEP_CYCLES)
                t0 = time.perf_counter()
                for _ in range(200):
                    run()
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                print(f"host time a dia_mv call (check, plan, launch): {host_us:.1f} us")
            del A

    # -- 5. K2 against its plain version, K1 on dataT and cuSPARSE beside -----
    for (tag, name), (shape, offs, ne) in sets2.items():
        dtype, tol = dtypes[tag]
        nd, nrows = shape
        data = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=dev)
        x = torch.as_tensor(rng.normal(size=nrows), dtype=dtype, device=dev)
        offs_dev = torch.tensor(offs, dtype=torch.int32, device=dev)
        plan = dia_kernel.launch_plan(nd, ne, nrows, dtype)
        run = lambda: dia_kernel.dia_rmv(data, offs_dev, x, ne)  # noqa: E731
        y, rel = compare("dia_rmv", (name, tag), run,
                         dia_kernel.dia_rmv_ref(data, offs, x, ne), tol)
        dataT = transpose_layout(data, offs, ne)
        neg_dev = -offs_dev
        run_k1 = lambda: dia_kernel.dia_mv(dataT, neg_dev, x)  # noqa: E731
        rel_k1 = ((run_k1() - y).abs().max() / y.abs().max()).item()
        check(rel_k1 <= tol, f"K1 on dataT disagrees with K2 on {name} {tag} ({rel_k1:.2e})")
        At = mb.banded_csr(data, offs, ne, transpose=True)
        rel_lib = ((At @ x - y).abs().max() / y.abs().max()).item()
        rec = timing("dia_rmv", name, tag, run, lambda: At @ x,
                     lambda: dia_kernel.dia_rmv_ref(data, offs, x, ne),
                     mb.band_entries(offs, nrows, ne), nrows, ne, dtype, nd, nrows)
        # K2 and K1 on dataT in turns (K2, K1, K1, K2), cold, each its faster turn
        t = [mb.cold_ms(f, 30) for f in (run, run_k1, run_k1, run)]
        rec["k2_turns_ms"], rec["k1_dataT_ms"] = min(t[0], t[3]), min(t[1], t[2])
        ratio = rec["k2_turns_ms"] / rec["k1_dataT_ms"]
        report(f"K2 {name} nd={nd} nrows={nrows} ne={ne} offsets {min(offs)}..{max(offs)} {tag} "
               f"(tile {plan.tile}, warps {plan.warps}, cluster {plan.cluster})", rec, rel,
               f"; cuSPARSE err {rel_lib:.1e}; in turns K2 {rec['k2_turns_ms']:.4f} and K1 on "
               f"dataT {rec['k1_dataT_ms']:.4f} ms cold (K2/K1 {ratio:.2f})")
        del dataT, At
    torch.cuda.empty_cache()

    # -- 6. small input: the card's path against the CPU plain path --------
    small = {}
    for where in ("cuda", "cpu"):
        p = swelling_3d(3, overrides=dict(BENCH_OVERRIDES, dtype="float64"),
                        device=dev if where == "cuda" else "cpu")
        dia_kernel.reset_counts()
        its = p.solve()
        small[where] = (its[0], p.sol.cpu().numpy(), dict(dia_kernel.COUNTS))
    err = np.abs(small["cuda"][1] - small["cpu"][1]).max() / np.abs(small["cpu"][1]).max()
    print(f"N=3 f64 card vs CPU: iterations {small['cuda'][0]} vs {small['cpu'][0]}, "
          f"max rel diff of x {err:.2e}; card counts {small['cuda'][2]}")
    check(small["cuda"][2]["dia_rmv"] > 0, "K2 did not run in the N=3 f64 card solve")
    check(small["cuda"][2]["plain"] == 0, "the N=3 card solve took a plain version")
    check(small["cuda"][0] == small["cpu"][0], "N=3 iteration counts differ")
    check(err <= 1e-10, "N=3 solutions differ")
    check(np.isfinite(small["cuda"][1]).all(), "non-finite N=3 solution")

    # -- 7. K3's path: the microbench -----------------------------------------
    dia_kernel.reset_counts()
    mbrec = mb.run()
    launches_k3 = dia_kernel.COUNTS["dia_mv_padded"]
    mb.report(mbrec)
    check(launches_k3 > 0, "K3 was never launched by the microbench")

    # -- 8. the reference drivers' path, f64 --------------------------------
    from porotpu_torch.drivers import footing, swelling
    from porotpu_torch.ops.sparse import ELL_PRODUCTS

    drivers_by_name = {"swelling": swelling, "footing": footing}
    held, mismatches = [], []
    for label, drv, argv, dofs, oracle, k2 in DRIVER_RUNS:
        out = driver_run(label, drivers_by_name[drv], argv, dofs, oracle, k2, dev, torch,
                         dia_kernel, ELL_PRODUCTS, FieldwiseTest, mb)
        if label == "swelling_exact":
            pc = out["problem"].pc
            check(pc.solve_s.kind == "lu" and pc.solve_fp.kind == "lu",
                  "petsc-options-exact did not build dense-LU solid and fp solves")
        held += [(label, *h) for h in out["held"]]
        if out["iterations"] != oracle:
            mismatches.append(f"{label}: {out['iterations']} iterations, porotpu took {oracle}")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    print("-- the driver runs' heaviest sets against their plain versions "
          "(random data at their shapes and offsets)")
    for label, key, offs, ne, vec, n_path in held:
        print(f" {label}, {n_path} launches of this set on this path in the solve:")
        hold_set(key, offs, ne, vec, dev, torch, dia_kernel, mb, rng)

    # -- 9. the drivers' defaults: card against CPU ---------------------------
    dflt = {}
    for where in ("cuda", "cpu"):
        p = swelling.setup(DEFAULTS_RUN + ["--device", where])
        dia_kernel.reset_counts()
        its = p.solve()
        dflt[where] = (its, p.sol.cpu().numpy(), dict(dia_kernel.COUNTS))
        del p
    err = np.abs(dflt["cuda"][1] - dflt["cpu"][1]).max() / np.abs(dflt["cpu"][1]).max()
    print(f"swelling {' '.join(DEFAULTS_RUN)} (full-residual, cg+amg) card vs CPU: iterations "
          f"{dflt['cuda'][0]} vs {dflt['cpu'][0]}, max rel diff of x {err:.2e}; "
          f"card counts {dflt['cuda'][2]}", flush=True)
    check(dflt["cuda"][2]["dia_mv"] > 0 and dflt["cuda"][2]["dia_rmv"] > 0,
          "K1 or K2 did not run in the full-residual card run")
    check(dflt["cuda"][2]["plain"] == 0, "the full-residual card run took a plain version")
    check(len(dflt["cuda"][0]) == 3 and dflt["cuda"][0] == dflt["cpu"][0],
          "full-residual iteration counts differ between card and CPU")
    check(err <= 1e-10, "full-residual solutions differ between card and CPU")
    check(not mismatches, "; ".join(mismatches))
    check_imports()

    k1, k2, k3 = record["dia_mv", "L0_A", "f32"], record["dia_rmv", "L0_P", "f64"], mbrec["k3"]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "dia_mv", "route": "cuda", "source": "porotpu_torch/csrc/dia_mv.cu",
         "replaces": "porotpu/ops/pallas_dia.py:130", "launches": counts32["dia_mv"],
         "max_abs_err": max_abs["dia_mv"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "dia_rmv", "route": "cuda", "source": "porotpu_torch/csrc/dia_rmv.cu",
         "replaces": "porotpu/ops/pallas_dia.py:246", "launches": counts64["dia_rmv"],
         "max_abs_err": max_abs["dia_rmv"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
        {"name": "dia_mv_padded", "route": "cuda",
         "source": "porotpu_torch/csrc/dia_mv_padded.cu",
         "replaces": "tools/pallas_dia.py:98", "launches": launches_k3,
         "max_abs_err": mbrec["max_abs_err"], "ms": k3["ms"], "plain_ms": mbrec["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": mbrec["cusparse"]["ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

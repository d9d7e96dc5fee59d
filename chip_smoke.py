#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (porotpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), nvcc and torch
   versions, and builds every kernel (porotpu_torch/csrc/*.cu, one nvcc
   per source, all together) from the checkout, printing the build time
   and ptxas's register report.  Then the stream peak measured on the
   card in f32 and f64 (utils/roofline.py: a chained triad over 256 MB
   arrays), measured once here; every bound share below is printed
   against the data sheet's 3.35 TB/s and against this measured peak.
1b. The ELL kernel (csrc/ell_mv.cu) at the benchmark cells' ELL shapes
   (``dia_microbench.ELL_SHAPES``), f64 and f32, through ``ELL.matvec``:
   cold and warm beside its bound (values, int32 columns, input and
   output once), the plain version (``ell_mv_ref``) and torch's
   gather-mul-sum on int64 columns (the port's product before the kernel);
   two launches bitwise equal, the plain version's answer to 1e-12 (f64)
   or 1e-5 (f32) of max|y|, and no product on the plain version.  Each
   ELL time is printed beside the stored layout's bound (pads included,
   as ``ell_roofline`` counts them) and the nonzeros' alone.  The driver
   runs below check that every ELL product of a solve launched the kernel
   and none took the plain version; the kernel record's launches are
   those of footing_inexact's solve (phase 8), its times phase 1b's 3D
   level-0 P in f64.
2. Main path, K1: swelling-3d N=13 with the bench.py overrides (120,842
   dofs, pad multiple 128, f32, loads-only), one time step through
   ``problem.solve()``: FGMRES + the 2-way block preconditioner with AMG.
   The dispatch counts are reset just before and read just after; the
   run fails unless K1 launched, K2 did not (f32 transposes run K1 on
   dataT) and no banded product took a plain PyTorch version.  The
   launches of the step are also printed by operator (kernel, dtype, nd,
   nrows).  Then bench.py's datapoint on the stepped problem
   (porotpu_torch/tools/bench.py:datapoint): three timed solves on
   distinct right-hand sides (CUDA events, median), the true-residual
   field-wise guard and the SpMV rate of the block operator against the
   measured peak and the data sheet.  The peak device memory of the step
   is printed net of what earlier phases still hold.
3. K2's path: the same configuration in f64, where no operator stores
   dataT and every transpose (each restriction P^T r, each Transposed
   coupling block) runs K2.  One step with the counts reset around it
   (K2 and K1 launched, no plain product), three timed solves and the
   guard (bench's datapoint).
3b. CastPC, bench.py's f64 datapoint: the f64 solve with the whole PC
   built in f32 (``pc dtype`` float32).  One step, counts reset around
   it: BENCH_r05's 9 iterations and the guard; K1 launched in f32 (the PC
   payload, its transposes on dataT), K2 in f64 (the operator's
   Transposed pressure rows) and never in f32; no plain product.  Then
   bench's datapoint, as in phase 2.
3c. bench.py's f64-IR datapoint through porotpu_torch/tools/bench.py:
   f32 solves (phase 2's problem) against the f64 true residual of phase
   3b's operator, 1-4 passes, ending with the field-wise test met in f64
   (atol 1e-8 / rtol 1e-6); no plain product.
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
   The 3-way block PC through the same drivers, with the command lines of
   paper-scripts/robustness_2d.sh and porotpu's first-step counts
   (output/SUMMARY.md): swelling N=80 ``diagonal 3-way`` inexact (6
   iterations), swelling N=20 exact (11; s/f/p/diff solves all dense LU)
   and footing N=20 ``undrained 3-way`` inexact (31,520 dofs, 248), each
   with the same checks and held sets; each must launch K2.
   The quasi-exact protocol (petsc-options-exact-iterative, the
   robustness grid's exact cells above the dense cap): swelling N=80 2-way
   (7 iterations; the fp block is the ``fgmres+fs`` solve: 60 FGMRES
   iterations at most on the saddle fp operator, stopped at rtol 1e-12,
   preconditioned by the Schur fieldsplit with 20 cg+amg fluid
   iterations and a dense-LU Schur part), footing N=20 2-way undrained
   (27; no banded transpose, no K2) and swelling N=80
   ``diagonal 3-way`` (6; every block cg+amg at 60 iterations).  Each run
   also prints its host syncs in the solve (``torch.cuda``'s sync debug
   mode, one warning a sync) and the inner FGMRES iterations of each fp
   apply.
9. The drivers' defaults (full-residual RHS, cg+amg inner solves):
   swelling N=6 over three steps on the card and with ``--device cpu``
   must take the same iterations at every step and agree to 1e-10.
10. AMG without coordinates (greedy aggregation of the strength graph):
   ``amg_setup(coords=None)`` on swelling N=80's solid block as assembled
   (f64, symmetric positive definite; rigid-body near-nullspace, the
   drivers' AMG settings), its host
   setup time, levels and each prolongator's storage format; then the
   port's outer ``cg`` at rtol 1e-8 from one seeded right-hand side with
   that AMG, on the card (counts reset around it: K1 launched, no plain
   product) and on the CPU: the same iteration count and solutions within
   1e-10 relative.
11. The outer solvers beyond FGMRES and the subsystem drivers, f64, each
   through its driver's ``setup`` and ``solve()`` with the counts reset
   just before the solve and read just after (OUTER_RUNS, porotpu's
   counts): swelling N=80 ``--solver-type aar`` at the drivers' defaults
   (32; the [R]/[A] step mix from its monitor; the field-wise guard is
   printed and not required, since AAR stops on its preconditioned
   residual), swelling N=80 petsc-options-inexact with
   ``--inner-accel-order 1`` (16, the guard required), solid N=16 (cg +
   AMG, 14; ||b - A x|| at most 10 times porotpu's; its prolongators
   store ELL and Dense, as porotpu's, so no K2) and fluid-pressure N=16
   (fgmres + selfp Schur fieldsplit, 14; ||b - A x|| likewise; K2 on the
   Transposed pressure rows).  Each run: K1 launched, no plain
   product, K2 as its operator walk finds banded transposes, its host
   syncs, launches an iteration, setup and solve s, peak memory, and its
   heaviest K1/K2 sets held against the plain version at 1e-12.  Then
   swelling N=6 aar and solid N=4 on the card and with ``--device cpu``:
   the same counts, solutions within 1e-10 relative.
12. The solver cache, export and checkpoint/resume, and the inner
   monitors, in a temporary directory (nothing lands in the checkout's
   ``.cache/`` or ``output/``), each solve with the counts reset just
   before and read just after (K1 launched, no plain product).
   12a, the bench path: swelling-3d N=13 f32 through
   ``tools/bench.build_problem`` with the cache there, first built and
   saved, then restored into a fresh problem: 9 iterations each and
   bench's guard; printed: setup s cold, the pickle's s on the setup's
   thread and its write after, setup s cached, the file's MiB, and
   max |x_cached - x_fresh|.  12b, export and resume on the driver path:
   swelling N=80 petsc-options-inexact f64 (``--output``, VTU: the card's
   machine has no h5py), the loop of ``AbstractPhysics.solve`` over two
   steps with a checkpoint after step 1 (porotpu's 16 iterations); a
   fresh problem loads the checkpoint and solves step 2: the straight
   run's count, x within 1e-10 relative, the guard at both steps; the
   VTU/PVD files parse.  12c, ``--inner-monitor``: swelling N=20 inexact
   on the card and with ``--device cpu``, the same labels and lines, |r|
   within 1e-8 relative or, for a block solved to rounding, both under
   1e-10 of the run's largest |r| (at N=6 every block's AMG is one level,
   a direct solve, and each |r| is rounding); then swelling N=80 inexact
   with the monitors: 16 iterations, one s and one fp_f line an apply.
13. The robustness grid's runner (``porotpu_torch/tools/robustness.py``,
   ``run`` and ``summarize``, the code of ``python -m
   porotpu_torch.tools.robustness``) into a temporary ``output/torch``:
   swelling 2-way inexact N=160 (438,085 dofs, the grid's largest
   swelling cell; its 25,921-row Schur block is past the dense-LU cap and
   falls back to cg+amg), in the runner's child process with the counts
   reset just before its solve and read just after.  It must give
   porotpu's 17 iterations, converge, meet the true-residual field-wise
   guard, launch K1 and K2 and take no plain product; a failed cell fails
   the script.  Printed: dofs, setup and solve s, peak device memory,
   then ``--summarize`` of what ran, against porotpu's logs.
14. The row-sharded solve (``porotpu_torch/tools/multichip.py``, the code
   of ``python -m porotpu_torch.tools.multichip``): swelling N=40 with the
   3-way block PC and cg+amg inner solves, rtol 1e-5, pad multiple the
   world size W, one step (__graft_entry__.py's dryrun_multichip
   problem), in f64 and in f32, (a) over NCCL at W=1 in this process (the
   group made and destroyed around each run; the halos are empty), (b)
   over gloo at W=2, two ranks spawned as child processes sharing the
   one card (their messages pass through the host; the kernels, built in
   phase 1, run on the card).  Each run resets the counts just before
   its sharded solve and reads them just after; it must give the
   unsharded port solve's count of the same padded problem, meet the
   true-residual field-wise guard, launch K1 and K2 and no plain
   product, and gather no vector longer than the largest padded field.
   The guard is taken on the gathered sharded x through the unsharded
   operator.  Its x must lie within 1e-8 relative of the unsharded x in
   f64, and within 5e-3 in f32, where the sharded path's K2 rounds
   otherwise than the unsharded K1 on dataT (an f32 solve lies 2.8e-2
   from the f64 one).  f32 K2 runs only on the sharded path (a sharded
   operator holds no dataT).  At W=2 each halo product
   makes 2 exchanges.  Printed: the collectives of a solve and the median
   solve time sharded against unsharded.  Then the other solve paths on
   the mesh, the swelling driver's command lines in f64
   (``MULTICHIP_DRIVER_RUNS``): (a) ``--solver-type aar``, (b)
   ``petsc-options-inexact --inner-accel-order 1``, (c)
   ``petsc-options-exact-iterative`` (the ``fgmres+fs`` fp solve) at N=80
   and (d) ``--solver-type cg`` with ``solver maxiter`` 20 at N=40, over
   NCCL at W=1 (the unsharded solve of (a)-(c) reused from phases 8 and
   11), and all four over gloo at W=2 at N=20, two ranks each, the four
   started together before the NCCL runs and waited on after them.  Each
   must give the unsharded port's count (at W=1 porotpu's 32, 16 and 7;
   (d) is declared to stop at 20 unconverged on both sides, every other
   run must converge on both), x within 1e-8 relative, the guard through
   the unsharded operator (for the converged runs), K1 launched and no
   plain product, 2 exchanges a halo product at W=2, and for (c) one
   inner FGMRES count an outer iteration, printed beside the unsharded
   run's.  Under gloo a halo matvec waits for its exchange and launches
   once (``RowMesh.halo_split``: only NCCL launches the interior under
   the exchange, which needs two cards).

Any failed check raises and the script exits non-zero.  It also exits
non-zero without a CUDA device, and fails if jax or any module of porotpu
was imported.  The last two stdout lines are the JSON kernel record and
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import warnings

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
    # the 3-way block PC (paper-scripts/robustness_2d.sh's command lines)
    ("swelling_3way_inexact", "swelling",
     ["-N", "80", "--petsc-options", "petsc-options-inexact", "--pc-type", "diagonal 3-way"],
     110245, [6], True),
    ("swelling_3way_exact", "swelling",
     ["-N", "20", "--petsc-options", "petsc-options-exact", "--pc-type", "diagonal 3-way"],
     7165, [11], True),
    # footing: its outer couplings and fluid levels store ELL, as in the
    # 2-way runs, but the pressure and diffusion AMGs keep banded
    # prolongators (143 x 1884, 444 and 445 x 400), as porotpu's
    # device_matrix picks them: their restrictions run K2
    ("footing_3way_inexact", "footing",
     ["-N", "20", "--petsc-options", "petsc-options-inexact", "--pc-type", "undrained 3-way"],
     31520, [248], True),
    # the quasi-exact protocol (paper-scripts/robustness_2d.sh's qexact
    # cells): the fp block is the fgmres+fs solve, the 3-way blocks cg+amg;
    # footing's fp operator and prolongators store ELL, as in its 2-way
    # inexact run
    ("swelling_qexact", "swelling",
     ["-N", "80", "--petsc-options", "petsc-options-exact-iterative"], 110245, [7], True),
    ("footing_qexact", "footing",
     ["-N", "20", "--petsc-options", "petsc-options-exact-iterative", "--pc-type", "undrained"],
     31520, [27], False),
    ("swelling_3way_qexact", "swelling",
     ["-N", "80", "--petsc-options", "petsc-options-exact-iterative",
      "--pc-type", "diagonal 3-way"], 110245, [6], True),
)
# phase 11: label, driver, command line, dofs, porotpu's iterations
# (porotpu, CPU run, f64, first step t=0.1), porotpu's final ||b - A x||
# for the subsystems (None: the 3-field problem's guard), K2 expected (None:
# as the operator walk finds banded transposes)
OUTER_RUNS = (
    ("swelling_aar", "swelling", ["-N", "80", "--solver-type", "aar", "--monitor"],
     110245, [32], None, None),
    ("swelling_inexact_accel1", "swelling",
     ["-N", "80", "--petsc-options", "petsc-options-inexact", "--inner-accel-order", "1"],
     110245, [16], None, None),
    # solid's prolongators store ELL and Dense, as porotpu's: no K2
    ("solid", "solid", ["-N", "16", "--dtype", "float64"], 107811, [14], 6.755e-13, None),
    ("fluid_pressure", "fluid_pressure", ["-N", "16", "--dtype", "float64"], 112724, [14],
     1.265e-13, None),
)
# phase 11: card against CPU
OUTER_CPU_RUNS = (
    ("swelling", ["-N", "6", "--solver-type", "aar"]),
    ("solid", ["-N", "4", "--dtype", "float64"]),
)
# phase 10: swelling N=80's solid block, AMG without coordinates
GREEDY_RUN = ["-N", "80"]
GREEDY_RTOL = 1e-8
# phase 8 holds, from each run, this many of its heaviest K1 sets, K2 sets
# and scalar-path sets against the plain version
HELD_SETS = 4
# phase 9: the drivers' defaults over three steps
DEFAULTS_RUN = ["-N", "6", "--time-final", "0.3"]
# phase 12: export and resume, and the inner monitors (card against CPU,
# then at full size); porotpu's first-step count at N=80
RESUME_RUN = ["-N", "80", "--petsc-options", "petsc-options-inexact", "--time-final", "0.2",
              "--output"]
MONITOR_CPU_RUN = ["-N", "20", "--petsc-options", "petsc-options-inexact", "--inner-monitor"]
MONITOR_RUN = ["-N", "80", "--petsc-options", "petsc-options-inexact", "--inner-monitor"]
# phase 13: cells of the robustness grid, their dofs and porotpu's count
# (output/robustness-2d-*.out, output/SUMMARY.md)
GRID_CELLS = (("swelling-2way-inexact-160", 438085, 17),)
# phase 14: the sharded runs, (world, backend, dtype)
MULTICHIP_RUNS = ((1, "nccl", "float64"), (1, "nccl", "float32"),
                  (2, "gloo", "float64"), (2, "gloo", "float32"))
# phase 14: the other solve paths on the mesh, the swelling driver's
# command lines in f64: label, flags, N under NCCL at W=1, parameter
# overrides, whether the solves converge (False: both stop at their
# maxiter, outer cg on the nonsymmetric system), porotpu's count at that
# N (phase 11's and 8's oracles; None: the unsharded port's count alone)
# and the phase 8 or 11 run whose unsharded solve W=1 reuses; gloo at W=2
# runs them at MULTICHIP_GLOO_N
MULTICHIP_DRIVER_RUNS = (
    ("a aar", ["--solver-type", "aar"], 80, {}, True, 32, "swelling_aar"),
    ("b accel1", ["--petsc-options", "petsc-options-inexact", "--inner-accel-order", "1"], 80,
     {}, True, 16, "swelling_inexact_accel1"),
    ("c qexact", ["--petsc-options", "petsc-options-exact-iterative"], 80, {}, True, 7,
     "swelling_qexact"),
    ("d cg", ["--solver-type", "cg"], 40, {"solver maxiter": 20}, False, None, None),
)
MULTICHIP_GLOO_N = 20


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


def path_run(label, problem, dev, torch, dia_kernel, bench, peak_gbps):
    """One step through ``problem.solve()`` (host setup included) with the
    dispatch counts reset just before and read just after, then bench.py's
    datapoint on it (``bench.datapoint``: three timed solves on distinct
    right-hand sides, the true-residual guard, the SpMV roofline against
    ``peak_gbps``).  Returns the dispatch counts of the step, and its
    launches by operator."""
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
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

    rec = bench.datapoint(problem, peak_gbps)
    print("timed solves (ms): " + ", ".join(f"{t * 1e3:.3f}" for t in rec["times_s"])
          + f"; median {rec['value']:.5f} s, {rec['iters']} iterations")
    print(f"true residual fieldwise: abs={rec['guard_abs']:.3e} rel={rec['guard_rel']:.3e} "
          f"(bench's guard: abs < {bench.GUARD_ATOL:g} or rel < {bench.GUARD_RTOL:g})")
    print(bench.roofline_line(f"N=13 block operator, {label}", rec))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak device memory allocated: {peak / 2**20:.1f} MiB; net of the "
          f"{held / 2**20:.1f} MiB held before the step, {(peak - held) / 2**20:.1f} MiB",
          flush=True)
    if iterations != [9]:
        print(f"NOTE: {iterations[0]} iterations, the porotpu oracle (BENCH_r05) took 9")
    return counts, launches


def _argv(argv):
    """A command line with the options file as a path into the checkout."""
    return [os.path.join(ROOT, a) if a.startswith("petsc-options") else a for a in argv]


def operators(roots):
    """One walk over device operators (a problem's A_dev, PC and H_dev; a
    subsystem's E and M): type name -> modules, for DIA, ELL, Transposed
    and AMGLevel."""
    ops = {"DIA": [], "ELL": [], "Transposed": [], "AMGLevel": []}
    for root in roots:
        for m in root.modules() if root is not None else ():
            ops.get(type(m).__name__, []).append(m)
    return ops


def banded_transposes(ops):
    """The banded operators whose transpose product a solve takes: the DIA
    inside a Transposed block, and a DIA prolongator (restriction P^T r).
    In f64 no dataT is stored, so each of these runs K2."""
    cands = [m.inner for m in ops["Transposed"]] + [m.P for m in ops["AMGLevel"]]
    return [m for m in cands if type(m).__name__ == "DIA"]


def time_ell(run, data, cols, n_in, torch, mb, peaks):
    """Cold and warm time of ``run``, one ELL product that reads the
    (n, width) values ``data`` and columns ``cols`` and an input of n_in,
    beside two bounds at the data sheet's bandwidth: the stored layout's
    (every slot's value and column, pads included, as ``ell_roofline``
    counts them) and the nonzeros' alone (the bytes the product needs);
    both read the input and write the output once.  Returns the record
    and a line that prints it."""
    n, width = data.shape
    item, vec = data.element_size(), (n_in + n) * data.element_size()
    slots, nnz = n * width, int(torch.count_nonzero(data))
    nbytes = slots * (item + cols.element_size()) + vec
    rec = dict(ms=mb.cold_ms(run, 30), warm_ms=mb.cuda_ms(run, 50), nbytes=nbytes)
    rec["bound_ms"], rec["bound_by"] = mb.bound(nbytes, 2 * slots, data.dtype)
    rec["nnz_bound_ms"], _ = mb.bound(nnz * (item + cols.element_size()) + vec, 2 * nnz,
                                      data.dtype)
    share = mb.shares(rec["ms"], nbytes, 2 * slots, data.dtype, peaks[data.dtype])
    line = (f"cold {rec['ms']:.4f} ms ({share}; stored layout {nbytes / 1e6:.1f} MB), warm "
            f"{rec['warm_ms']:.4f} ms; nonzeros {100 * nnz / max(slots, 1):.1f}% of the slots, "
            f"their bound {rec['nnz_bound_ms']:.4f} ms "
            f"({100 * rec['nnz_bound_ms'] / rec['ms']:.1f}%)")
    return rec, line


def ell_phase(dev, torch, dia_kernel, mb, peaks):
    """Phase 1b: the ELL kernel at the benchmark cells' ELL shapes, each
    held against its plain version; returns the times of the heaviest (the
    3D cell's level-0 P, f64)."""
    import numpy as np

    from porotpu_torch.ops.sparse import ELL, ell_mv_ref

    dia_kernel.reset_counts()
    heaviest = None
    for n, width, n_in in mb.ELL_SHAPES:
        data, cols = mb.random_ell(n, width, n_in, seed=n + width)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            E = ELL(torch.as_tensor(data, dtype=dtype), torch.from_numpy(cols), n_in).to(dev)
            x = torch.as_tensor(np.random.default_rng(n).normal(size=n_in), dtype=dtype,
                                device=dev)
            first, second = E.matvec(x), E.matvec(x)
            ref = ell_mv_ref(E.data, E.cols, x)
            torch.cuda.synchronize()
            rel = ((first - ref).abs().max() / ref.abs().max()).item()
            label = f"ELL {n} x {width} over {n_in}, {str(dtype).removeprefix('torch.')}"
            check(torch.equal(first, second), f"{label}: two launches differ")
            check(rel <= tol, f"{label} disagrees with its plain version ({rel:.2e})")
            cols64 = E.cols.long()
            rec, line = time_ell(lambda: E.matvec(x), E.data, E.cols, n_in, torch, mb, peaks)
            rec.update(plain_ms=mb.cold_ms(lambda: ell_mv_ref(E.data, E.cols, x), 10),
                       library_ms=mb.cold_ms(lambda: (E.data * x[cols64]).sum(1), 10),
                       err=(first - ref).abs().max().item())
            print(f"{label}: err {rel:.2e}; {line}; plain {rec['plain_ms']:.4f} ms; torch "
                  f"gather-mul-sum (int64 columns) {rec['library_ms']:.4f} ms", flush=True)
            if dtype == torch.float64 and (heaviest is None or rec["nbytes"] > heaviest["nbytes"]):
                heaviest = rec
    counts = dict(dia_kernel.ELL_COUNTS)
    check(counts["plain"] == 0 and counts["ell_mv"] > 0,
          f"ELL phase: {counts['ell_mv']} launches, {counts['plain']} plain products")
    return heaviest


def time_heaviest_ell(ops, ell, torch, mb, peaks):
    """Cold and warm time of the ELL product of each kind (A's layout, the
    stored transposed layout) that took the most of a solve's ELL work
    (products x rows x width), beside its bounds (``time_ell``)."""
    ells = {(str(m.data.dtype).removeprefix("torch."), *m.data.shape): m for m in ops["ELL"]}
    for product in ("matvec", "rmatvec"):
        keys = [k for k in ell if k[0] == product and k[1:] in ells]
        if not keys:
            continue
        key = max(keys, key=lambda k: ell[k] * k[2] * k[3])
        op = ells[key[1:]]
        # the layout the product reads: A's, or the transposed one
        data, cols = (op.data, op.cols) if product == "matvec" else (op.dataT, op.colsT)
        n, width = data.shape
        n_in = op.ncols if product == "matvec" else op.data.shape[0]
        x = torch.randn(n_in, dtype=data.dtype, device=data.device)
        run = getattr(op, product)
        rec, line = time_ell(lambda: run(x), data, cols, n_in, torch, mb, peaks)
        print(f"heaviest ELL {product} ({n} rows x {width}, {ell[key]} products in the solve): "
              f"{line}; x (cold - bound) over the solve "
              f"{ell[key] * (rec['ms'] - rec['bound_ms']):.1f} ms", flush=True)


@contextlib.contextmanager
def count_syncs(torch):
    """Count into ``["n"]`` the host syncs torch.cuda reports in its sync
    debug mode, one warning a synchronizing call."""
    counter = {"n": 0}
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counter
        finally:
            torch.cuda.set_sync_debug_mode("default")
            counter["n"] = sum("synchroniz" in str(w.message) for w in log)


def driver_run(label, drv, argv, dofs, oracle, k2, dev, torch, dia_kernel, ell_products,
               inner_iters, FieldwiseTest, mb, peaks, guard=True):
    """One driver run on the card: ``setup(argv)``, then ``solve()`` with the
    counts reset just before and read just after, then ``print_timings()``.
    Checks the dofs, the true-residual guard at the problem's own
    tolerances, K1 > 0 in f64, no plain product, and K2 as the run expects
    (``k2``: launched, or no banded transpose and no launch).  Prints the
    host syncs of the solve and the inner FGMRES iterations of each
    ``fgmres+fs`` apply (``inner_iters``, filled by the caller's hook).
    Returns the
    run's numbers and the sets to hold against the plain version: a list
    of ((kernel, dtype, nd, nrows), offsets, ne, vector path, launches).
    The iteration count is returned, not checked, so that every run
    reports before a count against porotpu's fails the script.  ``k2``
    None: K2 as the operator walk finds banded transposes.  ``guard``
    False: the field-wise guard is printed and not required (AAR stops on
    its preconditioned residual)."""
    import numpy as np

    print(f"-- {label}: python -m {drv.__name__} {' '.join(argv)}", flush=True)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    problem = drv.setup(_argv(argv))
    t_problem = time.perf_counter() - t0
    check(problem.device.type == "cuda" and problem.dtype == torch.float64,
          f"{label}: runs on {problem.device} in {problem.dtype}, not on the card in f64")
    n = problem.W.num_dofs
    check(n == dofs, f"{label}: {n} dofs, porotpu's run had {dofs}")
    # the host setup (first step's create_solver) outside the sync count:
    # moving the solver state to the card syncs once a buffer
    problem.create_solver()
    problem.first_timestep = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia_kernel.reset_counts()
    ell_products.clear()
    inner_iters.clear()
    with count_syncs(torch) as syncs:
        iterations = problem.solve()
    counts = dict(dia_kernel.COUNTS)
    ell_counts = dict(dia_kernel.ELL_COUNTS)
    launches = dict(dia_kernel.LAUNCHES)
    scalar = dict(dia_kernel.SCALAR_LAUNCHES)
    ell = dict(ell_products)
    fp_iters = list(inner_iters)
    peak = torch.cuda.max_memory_allocated(dev)
    res = problem.last_result
    hist = [float(h) for h in res.history[: res.iters + 1]]
    its = sum(iterations)
    k12 = counts["dia_mv"] + counts["dia_rmv"]
    n_scalar = sum(scalar.values())
    print(f"dofs={n} padded sizes={problem.padded_sizes}; problem built in {t_problem:.2f} s, "
          f"host setup {problem.t_setup:.2f} s, solve {problem.t_solve_total:.4f} s; "
          f"peak device memory {peak / 2**20:.1f} MiB, net of the {before / 2**20:.1f} MiB "
          f"held before the run {(peak - before) / 2**20:.1f} MiB")
    print(f"iterations={iterations} (porotpu {oracle}) converged={res.converged} "
          f"residual={res.res:.4e}")
    print("residual history:", " ".join(f"{h:.4e}" for h in hist))
    print("dispatch counts in the solve: " + ", ".join(f"{k}={v}" for k, v in counts.items())
          + f"; K1+K2 launches an iteration {k12 / max(its, 1):.1f} (K1 "
          f"{counts['dia_mv'] / max(its, 1):.1f}, K2 {counts['dia_rmv'] / max(its, 1):.1f})")
    print(f"host syncs in the solve: {syncs['n']} ({syncs['n'] / max(its, 1):.1f} an iteration)")
    if fp_iters:
        print(f"inner fgmres+fs: {len(fp_iters)} applies, iterations an apply "
              f"min {min(fp_iters)} max {max(fp_iters)}, total {sum(fp_iters)}")
    print(f"scalar-path launches: {n_scalar} of {k12} ({100 * n_scalar / max(k12, 1):.1f}%); "
          f"ELL products: {sum(ell.values())}")
    print_launches(launches, scalar, ell)
    problem.print_timings()
    sys.stdout.flush()

    b = problem.last_rhs
    atol = float(problem.parameters["solver atol"])
    rtol = float(problem.parameters["solver rtol"])
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, b)
        r = b - problem.A_dev.matvec(problem.sol)
        ea, er = (float(v) for v in fw.errors(r))
        rn, bn = torch.linalg.norm(r).item(), torch.linalg.norm(b).item()
    met = ea < atol or er < rtol
    print(f"true residual fieldwise: abs={ea:.3e} rel={er:.3e} (atol {atol:g}, rtol {rtol:g}"
          + ("" if guard else f"; printed, not required: {'met' if met else 'NOT met'}")
          + f"); ||b - A x|| {rn:.4e}, ||b|| {bn:.4e}, relative {rn / bn:.3e}; the solver's "
          f"own residual {res.res:.4e}, relative to its first {res.res / res.history[0]:.3e}",
          flush=True)
    check(res.converged, f"{label}: the solve did not converge")
    check(met or not guard, f"{label}: true-residual guard failed")
    check(np.isfinite(problem.sol.cpu().numpy()).all(), f"{label}: non-finite solution")
    check(any(k[:2] == ("dia_mv", "float64") for k in launches), f"{label}: K1 never ran in f64")
    check(counts["plain"] == 0, f"{label}: {counts['plain']} banded products took a plain version")
    check_ell(label, ell_counts, ell)
    ops = operators((problem.A_dev, problem.pc, problem.H_dev))
    transposes = banded_transposes(ops)
    print(f"banded operators applied transposed (K2's): {len(transposes)}; "
          f"DIA {len(ops['DIA'])}, ELL {len(ops['ELL'])}, Transposed {len(ops['Transposed'])}")
    check_k2(label, bool(transposes) if k2 is None else k2, transposes, counts)
    time_heaviest_ell(ops, ell, torch, mb, peaks)

    held = held_sets(launches, scalar, ops, k12)
    out = dict(iterations=iterations, launches=launches, scalar=scalar, counts=counts, held=held,
               solve_s=problem.t_solve_total, setup_s=problem.t_setup,
               peak_mib=(peak - before) / 2**20, fp_iters=fp_iters, ell_counts=ell_counts)
    out["problem"] = problem
    return out


def check_ell(label, ell_counts, ell):
    """Every ELL product of a run launched the ELL kernel: none took the
    plain version."""
    launched = ell_counts["ell_mv"] + ell_counts["ell_rmv"]
    check(ell_counts["plain"] == 0 and launched == sum(ell.values()),
          f"{label}: {sum(ell.values())} ELL products, {launched} kernel launches, "
          f"{ell_counts['plain']} plain")


def check_k2(label, k2, transposes, counts):
    """K2 launched where a run expects it; else no banded transpose and no K2."""
    if k2:
        check(counts["dia_rmv"] > 0, f"{label}: K2 was never launched")
    else:
        check(not transposes, f"{label}: {len(transposes)} banded transposes, none expected")
        check(counts["dia_rmv"] == 0, f"{label}: K2 launched with no banded transpose")


def print_launches(launches, scalar, ell):
    """A run's launches by operator, heaviest first, and its ELL products."""
    print("launches by operator (kernel dtype nd nrows: launches, of them scalar path):")
    for key, k in sorted(launches.items(), key=lambda kv: -kv[1] * kv[0][2] * kv[0][3]):
        print(f"  {' '.join(map(str, key))}: {k}, {scalar.get(key, 0)}")
    for key, k in sorted(ell.items()):
        print(f"  ELL {' '.join(map(str, key))}: {k}")
    sys.stdout.flush()


def held_sets(launches, scalar, ops, k12):
    """The sets of a run to hold against the plain version: the heaviest
    of each kernel over all launches (launches x diagonals x rows), and the
    heaviest scalar-path sets, each on the path the run took it.  A list of
    ((kernel, dtype, nd, nrows), offsets, ne, vector path, launches)."""
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
    return held


def hold_set(key, offs, ne, vec, dev, torch, dia_kernel, mb, rng, peaks):
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
    nbytes = (entries + n_in + n_out) * dtype.itemsize
    ms, warm = mb.cold_ms(run, 30), mb.cuda_ms(run, 50)
    lib, lib_warm = mb.cold_ms(lambda: A @ xc, 30), mb.cuda_ms(lambda: A @ xc, 50)
    share = mb.shares(ms, nbytes, 2 * entries, dtype, peaks[dtype])
    print(f"  {kernel} {dt} nd={nd} nrows={nrows} ne={ne} ({path}, cluster {plan.cluster}): "
          f"err {rel:.2e}; cold {ms:.4f} ms ({share}), "
          f"warm {warm:.4f} ms; cuSPARSE cold {lib:.4f} warm {lib_warm:.4f} ms",
          flush=True)
    return ms


def greedy_phase(swelling, dev, torch, dia_kernel, ell_products):
    """Phase 10: ``amg_setup(coords=None)`` on swelling N=80's solid block,
    then the port's ``cg`` with it on the card and on the CPU from one
    right-hand side."""
    import copy

    import numpy as np

    from porotpu_torch.precond.amg import amg_setup, rigid_body_modes
    from porotpu_torch.precond.inner import InnerConfig
    from porotpu_torch.solvers.cg import cg

    print(f"-- greedy AMG: the solid block of swelling {' '.join(GREEDY_RUN)}", flush=True)
    # the block as assembled: symmetric positive definite (its BC-applied
    # copy has its Dirichlet rows zeroed and not its columns, which CG
    # cannot take), with the rigid-body modes of its nodes
    prob = swelling.setup(GREEDY_RUN + ["--device", "cpu"])
    prob.assembler.assemble()
    A = prob.assembler.P_blocks[("s", "s")].tocsr()
    B = rigid_body_modes(prob.W.space("s").node_coords)
    cfg = InnerConfig()  # the drivers' AMG settings
    t0 = time.perf_counter()
    amg = amg_setup(
        A, dofs_per_node=prob.mesh.dim, B=B, theta=cfg.amg_theta,
        coarse_size=cfg.amg_coarse_size, presmooth=cfg.amg_presmooth,
        postsmooth=cfg.amg_postsmooth, smooth_degree=cfg.amg_smooth_degree,
        cheb_lower=cfg.amg_cheb_lower, p_drop_tol=cfg.amg_p_drop, dtype=torch.float64,
    )
    setup_s = time.perf_counter() - t0
    check(len(amg.levels) >= 1, "greedy AMG built no level")
    fmt = lambda op: type(op).__name__ + (  # noqa: E731
        f"({type(op.inner).__name__})" if type(op).__name__ == "Transposed" else "")
    print(f"host setup {setup_s:.2f} s for {A.shape[0]} rows; {len(amg.levels)} levels, "
          f"coarse dense {tuple(amg.coarse_inv.shape)}")
    for k, lv in enumerate(amg.levels):
        print(f"  level {k}: A {tuple(lv.A.shape)} {fmt(lv.A)}, P {tuple(lv.P.shape)} "
              f"{fmt(lv.P)}")
    cpu = copy.deepcopy(amg)
    amg = amg.to(dev)
    b = np.random.default_rng(7).normal(size=A.shape[0])
    out = {}
    with torch.inference_mode():
        for where, m in (("cuda", amg), ("cpu", cpu)):
            bt = torch.as_tensor(b, dtype=torch.float64, device=dev if where == "cuda" else "cpu")
            dia_kernel.reset_counts()
            ell_products.clear()
            t0 = time.perf_counter()
            res = cg(m.levels[0].A.matvec, bt, M=m, rtol=GREEDY_RTOL, atol=0.0, maxiter=500)
            x, its = res.x, res.iters
            if where == "cuda":
                torch.cuda.synchronize()
            out[where] = (x.cpu().numpy(), its, time.perf_counter() - t0,
                          dict(dia_kernel.COUNTS), sum(ell_products.values()))
    (xg, itg, tg, cg_counts, ellg), (xc, itc, tc, _, _) = out["cuda"], out["cpu"]
    err = np.abs(xg - xc).max() / np.abs(xc).max()
    print(f"cg rtol {GREEDY_RTOL:g}: card {itg} iterations in {tg:.3f} s, CPU {itc} in "
          f"{tc:.3f} s; max rel diff of x {err:.2e}; card counts {cg_counts}, ELL products "
          f"{ellg}", flush=True)
    check(itg == itc, f"greedy AMG cg: {itg} iterations on the card, {itc} on the CPU")
    check(err <= 1e-10, f"greedy AMG cg: card and CPU solutions differ ({err:.2e})")
    check(np.isfinite(xg).all(), "greedy AMG cg: non-finite solution")
    check(cg_counts["dia_mv"] > 0 and cg_counts["plain"] == 0,
          f"greedy AMG cg: K1 {cg_counts['dia_mv']} launches, {cg_counts['plain']} plain")


def subsystem_run(label, drv, argv, dofs, oracle, resid, k2, dev, torch, dia_kernel,
                  ell_products, mb, peaks):
    """One subsystem driver run on the card: ``setup(argv)`` (assembly,
    host setup, the operators moved to the card), then ``solve()`` with the
    counts reset just before and read just after.  Checks the dofs, f64,
    ||b - A x|| at most 10 times porotpu's ``resid``, K1 > 0, no plain
    product and K2 as ``check_k2``; returns the run's numbers and its sets
    to hold, as ``driver_run``."""
    import numpy as np

    print(f"-- {label}: python -m {drv.__name__} {' '.join(argv)}", flush=True)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    run = drv.setup(argv)
    t_build = time.perf_counter() - t0
    check(run.device.type == "cuda" and run.dtype == torch.float64,
          f"{label}: runs on {run.device} in {run.dtype}, not on the card in f64")
    check(run.b.size == dofs, f"{label}: {run.b.size} dofs, porotpu's run had {dofs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia_kernel.reset_counts()
    ell_products.clear()
    with count_syncs(torch) as syncs:
        its = run.solve()
    counts = dict(dia_kernel.COUNTS)
    ell_counts = dict(dia_kernel.ELL_COUNTS)
    launches = dict(dia_kernel.LAUNCHES)
    scalar = dict(dia_kernel.SCALAR_LAUNCHES)
    ell = dict(ell_products)
    peak = torch.cuda.max_memory_allocated(dev)
    res = run.result
    k12 = counts["dia_mv"] + counts["dia_rmv"]
    print(f"dofs={run.b.size}; built in {t_build:.2f} s (host setup after assembly "
          f"{run.t_setup:.2f} s), solve {run.t_solve:.4f} s; peak device memory "
          f"{peak / 2**20:.1f} MiB, net of the {before / 2**20:.1f} MiB held before the run "
          f"{(peak - before) / 2**20:.1f} MiB")
    print(f"iterations={its} (porotpu {oracle[0]}) converged={res.converged} "
          f"residual={res.res:.4e}; ||b - A x|| {run.residual:.4e} (porotpu {resid:.4e}, "
          f"at most {10 * resid:.4e})")
    print("residual history:", " ".join(f"{h:.4e}" for h in res.history[: res.iters + 1]))
    print("dispatch counts in the solve: " + ", ".join(f"{k}={v}" for k, v in counts.items())
          + f"; K1+K2 launches an iteration {k12 / max(its, 1):.1f} (K1 "
          f"{counts['dia_mv'] / max(its, 1):.1f}, K2 {counts['dia_rmv'] / max(its, 1):.1f})")
    print(f"host syncs in the solve: {syncs['n']} ({syncs['n'] / max(its, 1):.1f} an iteration); "
          f"ELL products: {sum(ell.values())}")
    print_launches(launches, scalar, ell)
    check(res.converged, f"{label}: the solve did not converge")
    check(run.residual <= 10 * resid, f"{label}: ||b - A x|| {run.residual:.3e} is above "
          f"10 x porotpu's {resid:.3e}")
    check(np.isfinite(res.x.cpu().numpy()).all(), f"{label}: non-finite solution")
    check(any(k[:2] == ("dia_mv", "float64") for k in launches), f"{label}: K1 never ran in f64")
    check(counts["plain"] == 0, f"{label}: {counts['plain']} banded products took a plain version")
    check_ell(label, ell_counts, ell)
    ops = operators((run.E, run.M))
    transposes = banded_transposes(ops)
    print(f"banded operators applied transposed (K2's): {len(transposes)}; "
          f"DIA {len(ops['DIA'])}, ELL {len(ops['ELL'])}, Transposed {len(ops['Transposed'])}")
    check_k2(label, bool(transposes) if k2 is None else k2, transposes, counts)
    held = held_sets(launches, scalar, ops, k12)
    return dict(iterations=[its], launches=launches, counts=counts, held=held,
                solve_s=run.t_solve, setup_s=run.t_setup, peak_mib=(peak - before) / 2**20,
                syncs=syncs["n"])


class Tee:
    """stdout that also keeps what was written (the AAR monitor's lines)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def outer_phase(dev, torch, dia_kernel, ell_products, inner_iters, FieldwiseTest, mb, peaks,
                rng, mismatches, references=None, reused=()):
    """Phase 11: OUTER_RUNS, their held sets, then OUTER_CPU_RUNS.  The
    unsharded solves of the runs in ``reused`` go into ``references``
    for phase 14."""
    import numpy as np

    from porotpu_torch.drivers import fluid_pressure, solid, swelling
    from porotpu_torch.tools import multichip

    drivers = {"swelling": swelling, "solid": solid, "fluid_pressure": fluid_pressure}
    held = []
    for label, drv, argv, dofs, oracle, resid, k2 in OUTER_RUNS:
        if resid is None:
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                out = driver_run(label, drivers[drv], argv, dofs, oracle, k2, dev, torch,
                                 dia_kernel, ell_products, inner_iters, FieldwiseTest, mb, peaks,
                                 guard="aar" not in argv)
            steps = [ln for ln in "".join(tee.text).splitlines() if ln.startswith("---- [AAR]")]
            if "aar" in argv:
                n_a = sum("[A]" in ln for ln in steps)
                print(f"AAR step mix: {len(steps) - n_a} [R], {n_a} [A] (p "
                      f"{out['problem'].parameters['AAR p']}, order "
                      f"{out['problem'].parameters['AAR order']})")
                check(len(steps) == sum(out["iterations"]),
                      f"{label}: {len(steps)} monitor lines for {out['iterations']} iterations")
            else:
                check(not steps, f"{label}: AAR ran; the options file's gmres shadows it")
            if label in reused:
                references[label] = multichip.reference_of(out["problem"], out["fp_iters"],
                                                          out["counts"])
        else:
            out = subsystem_run(label, drivers[drv], _argv(argv), dofs, oracle, resid, k2, dev,
                                torch, dia_kernel, ell_products, mb, peaks)
        held += [(label, *h) for h in out["held"]]
        if out["iterations"] != oracle:
            mismatches.append(f"{label}: {out['iterations']} iterations, porotpu took {oracle}")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    print("-- phase 11's heaviest sets against their plain versions "
          "(random data at their shapes and offsets)")
    for label, key, offs, ne, vec, n_path in held:
        print(f" {label}, {n_path} launches of this set on this path in the solve:")
        hold_set(key, offs, ne, vec, dev, torch, dia_kernel, mb, rng, peaks)

    for drv, argv in OUTER_CPU_RUNS:
        got = {}
        for where in ("cuda", "cpu"):
            run = drivers[drv].setup(argv + ["--device", where])
            dia_kernel.reset_counts()
            its = run.solve()
            x = (run.sol if drv == "swelling" else run.result.x).cpu().numpy()
            got[where] = (its, x, dict(dia_kernel.COUNTS))
            del run
        err = np.abs(got["cuda"][1] - got["cpu"][1]).max() / np.abs(got["cpu"][1]).max()
        print(f"{drv} {' '.join(argv)} card vs CPU: iterations {got['cuda'][0]} vs "
              f"{got['cpu'][0]}, max rel diff of x {err:.2e}; card counts {got['cuda'][2]}",
              flush=True)
        check(got["cuda"][2]["dia_mv"] > 0 and got["cuda"][2]["plain"] == 0,
              f"{drv} {argv}: K1 {got['cuda'][2]['dia_mv']}, plain {got['cuda'][2]['plain']}")
        check(got["cuda"][0] == got["cpu"][0], f"{drv} {argv}: counts differ, card and CPU")
        check(err <= 1e-10, f"{drv} {argv}: card and CPU solutions differ ({err:.2e})")


def step_guard(label, problem, torch, FieldwiseTest):
    """Check the true-residual field-wise guard of the problem's last step
    at its own tolerances; returns (abs, rel)."""
    b = problem.last_rhs
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, b)
        ea, er = (float(v) for v in fw.errors(b - problem.A_dev.matvec(problem.sol)))
    atol = float(problem.parameters["solver atol"])
    rtol = float(problem.parameters["solver rtol"])
    check(ea < atol or er < rtol, f"{label}: true-residual guard failed ({ea:.3e}, {er:.3e})")
    return ea, er


def counted(label, dia_kernel, fn):
    """Run ``fn`` with the dispatch counts reset just before and read just
    after; checks that K1 launched and no plain product ran."""
    dia_kernel.reset_counts()
    out = fn()
    counts = dict(dia_kernel.COUNTS)
    check(counts["dia_mv"] > 0, f"{label}: K1 was never launched")
    check(counts["plain"] == 0, f"{label}: {counts['plain']} banded products took a plain version")
    return out, counts


def bench_cache_phase(dev, torch, dia_kernel, bench, tmp, smi):
    """12a: the bench path's solver cache, built and saved, then restored."""
    import numpy as np

    print("-- 12a: the bench path's solver cache (swelling-3d N=13 f32, "
          "porotpu_torch/tools/bench.build_problem)", flush=True)
    cdir = os.path.join(tmp, "cache")
    t0 = time.perf_counter()
    cold = bench.build_problem("float32", device=dev, cache_dir=cdir)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold.cache_writer.join()
    t_write = time.perf_counter() - t0
    path = cold.parameters["solver cache path"]
    check(os.path.basename(path).startswith("torch_bench_") and os.path.exists(path),
          f"no cache file {path}")
    mib = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    warm = bench.build_problem("float32", device=dev, cache_dir=cdir)
    t_cached = time.perf_counter() - t0
    check(warm.cache_writer is None and not warm.first_timestep,
          "the second build_problem did not restore the cache")
    xs = {}
    for label, prob in (("fresh", cold), ("restored", warm)):
        its, counts = counted(f"12a {label}", dia_kernel, prob.solve)
        ea, er = bench.guard(prob, prob.last_rhs, prob.sol)
        print(f"{label}: iterations {its}, guard abs {ea:.3e} rel {er:.3e}; counts "
              + ", ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
        check(its == [9], f"12a {label}: {its} iterations, BENCH_r05 took 9")
        check(ea < bench.GUARD_ATOL or er < bench.GUARD_RTOL, f"12a {label}: guard failed")
        check(counts["dia_rmv"] == 0, f"12a {label}: K2 ran on the f32 path")
        xs[label] = prob.sol.cpu().numpy()
    diff = np.abs(xs["restored"] - xs["fresh"]).max()
    print(f"bench cache [{smi}]: setup cold {t_cold:.2f} s (host setup {cold.t_setup:.2f} s, "
          f"of it the pickle {cold.t_cache_save:.2f} s on the setup's thread), the write "
          f"{t_write:.2f} s after it; setup cached {t_cached:.2f} s (restore {warm.t_setup:.2f} "
          f"s); {mib:.1f} MiB; max |x_cached - x_fresh| {diff:.3e}", flush=True)
    check(np.isfinite(xs["restored"]).all(), "12a: non-finite restored solution")


def parse_vtk(path):
    """The root of a VTU or PVD file (xml.etree)."""
    import xml.etree.ElementTree as ET

    return ET.parse(path).getroot()


def resume_phase(dev, torch, dia_kernel, FieldwiseTest, tmp):
    """12b: export (VTU) and checkpoint/resume on the driver path."""
    import numpy as np

    from porotpu_torch.drivers import swelling
    from porotpu_torch.utils import io

    print(f"-- 12b: export and resume: python -m porotpu_torch.drivers.swelling "
          f"{' '.join(RESUME_RUN)} (VTU), a checkpoint after step 1", flush=True)
    cwd = os.getcwd()
    os.chdir(tmp)  # output/ lands in the temporary directory
    try:
        p = swelling.setup(_argv(RESUME_RUN))
        check(p.output_solutions and p.device.type == "cuda", "12b: no export, or not on the card")
        p.parameters["output format"] = "vtu"
        t0 = time.perf_counter()
        p.create_solver()
        p.first_timestep = False
        t_setup = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "step1.npz")
        # AbstractPhysics.solve's loop, a checkpoint between the steps
        p.export(p.t0)
        steps = []
        for step in (1, 2):
            p.t += p.dt
            its, counts = counted(f"12b step {step}", dia_kernel, lambda: p.solve_time_step(p.t))
            ea, er = step_guard(f"12b step {step}", p, torch, FieldwiseTest)
            p.export(p.t)
            steps.append((its, counts, ea, er))
            if step == 1:
                io.save_checkpoint(ckpt, p, p.t)
        x_straight = p.sol.cpu().numpy()
        mesh_nv = p.mesh.num_vertices
        del p
        gc.collect()
        q = swelling.setup(_argv(RESUME_RUN))
        t = io.load_checkpoint(ckpt, q)
        check(q.us_nm1.device.type == "cuda" and q.us_nm1.dtype == torch.float64,
              "12b: the checkpoint did not load onto the card in f64")
        q.create_solver()
        q.first_timestep = False
        q.t = t + q.dt
        its_r, counts_r = counted("12b resumed step 2", dia_kernel,
                                  lambda: q.solve_time_step(q.t))
        ea_r, er_r = step_guard("12b resumed step 2", q, torch, FieldwiseTest)
        x_r = q.sol.cpu().numpy()
        err = np.abs(x_r - x_straight).max() / np.abs(x_straight).max()
        for step, (its, counts, ea, er) in enumerate(steps, 1):
            print(f"step {step}: {its} iterations, guard abs {ea:.3e} rel {er:.3e}; counts "
                  + ", ".join(f"{k}={v}" for k, v in counts.items()))
        print(f"resumed step 2: {its_r} iterations, guard abs {ea_r:.3e} rel {er_r:.3e}; "
              f"max rel diff of x from the straight run {err:.2e}; host setup {t_setup:.2f} s; "
              "counts " + ", ".join(f"{k}={v}" for k, v in counts_r.items()), flush=True)
        check(steps[0][0] == 16, f"12b: step 1 took {steps[0][0]} iterations, porotpu's 16")
        check(its_r == steps[1][0], f"12b: resumed step 2 took {its_r}, straight {steps[1][0]}")
        check(err <= 1e-10, f"12b: resumed x differs from the straight run ({err:.2e})")
        pvd = parse_vtk(os.path.join("output", "swelling.pvd"))
        frames = [d.get("file") for d in pvd.iter("DataSet")]
        check(frames == [f"swelling_{i:06d}.vtu" for i in range(3)], f"12b: PVD lists {frames}")
        for f in frames:
            piece = next(parse_vtk(os.path.join("output", f)).iter("Piece"))
            names = [a.get("Name") for a in piece.iter("DataArray") if a.get("Name")]
            check(int(piece.get("NumberOfPoints")) == mesh_nv
                  and {"displacement", "fluid_velocity", "pressure"} <= set(names),
                  f"12b: {f} holds {piece.get('NumberOfPoints')} points, arrays {names}")
        print(f"VTU/PVD: {len(frames)} frames of {mesh_nv} points parsed, "
              f"{sum(os.path.getsize(os.path.join('output', f)) for f in frames) / 2**20:.1f} MiB",
              flush=True)
    finally:
        os.chdir(cwd)


def monitor_lines(text):
    """(label, |r|) of each inner-monitor line."""
    import re

    return [(lab, float(r)) for lab, r in
            re.findall(r"^  \[inner (\w+)\] \|r\|=(\S+)$", text, re.M)]


def monitor_phase(dev, torch, dia_kernel):
    """12c: --inner-monitor, card against CPU, then at full size."""
    from porotpu_torch.drivers import swelling

    from io import StringIO

    def run(argv, where):
        tee = Tee(sys.stdout if where == "cuda" else StringIO())
        with contextlib.redirect_stdout(tee):
            p = swelling.setup(_argv(argv) + ["--device", where])
            if where == "cuda":
                p.create_solver()
                p.first_timestep = False
                its, counts = counted(f"12c {' '.join(argv)}", dia_kernel, p.solve)
            else:
                its, counts = p.solve(), None
        return its, monitor_lines("".join(tee.text)), counts

    print(f"-- 12c: inner monitors, swelling {' '.join(MONITOR_CPU_RUN)} card against CPU",
          flush=True)
    its_c, card, _ = run(MONITOR_CPU_RUN, "cuda")
    its_h, host, _ = run(MONITOR_CPU_RUN, "cpu")
    check(its_c == its_h, f"12c: iterations {its_c} on the card, {its_h} on the CPU")
    check([lab for lab, _ in card] == [lab for lab, _ in host] and card,
          "12c: the card's monitor labels differ from the CPU's")
    floor = 1e-10 * max(r for _, r in host)
    worst = max(abs(a - b) / b if b > floor else 0.0 for (_, a), (_, b) in zip(card, host))
    check(all(abs(a - b) <= 1e-8 * b or max(a, b) <= floor for (_, a), (_, b) in zip(card, host)),
          "12c: the card's |r| differ from the CPU's")
    print(f"card = CPU: {len(card)} lines, labels {sorted(set(lab for lab, _ in card))}, "
          f"worst relative difference above the floor {worst:.2e} (floor {floor:.2e})",
          flush=True)
    print(f"-- 12c: swelling {' '.join(MONITOR_RUN)} on the card", flush=True)
    its, lines, counts = run(MONITOR_RUN, "cuda")
    print(f"{its} iterations, {len(lines)} monitor lines; counts "
          + ", ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    check(its == [16], f"12c: {its} iterations with the monitors on, porotpu's 16")
    check([lab for lab, _ in lines] == ["s", "fp_f"] * its[0],
          "12c: not one s and one fp_f line an apply")


def grid_phase(tmp):
    """13: cells of the robustness grid through the runner, each in its
    child process, into ``tmp``; then its table against porotpu's."""
    from porotpu_torch.tools import robustness

    names = [name for name, _, _ in GRID_CELLS]
    outdir = os.path.join(tmp, "output", "torch")
    print(f"-- 13: the robustness grid's runner: python -m porotpu_torch.tools.robustness "
          f"{' '.join(names)} --outdir {outdir} --cache-dir=", flush=True)
    failed = robustness.run(robustness.select(names), outdir, "cuda", cache_dir="")
    check(not failed, f"13: cells failed: {failed}")
    recs = {r["cell"]: r for r in robustness.records(outdir)}
    for name, dofs, oracle in GRID_CELLS:
        r = recs[name]
        print(f"{name}: dofs {r['dofs']}, {r['iterations']} iterations (porotpu {oracle}), "
              f"converged {r['converged']}, guard abs {r['guard_abs']:.3e} rel "
              f"{r['guard_rel']:.3e}; setup {r['setup_s']:.2f} s, solve {r['solve_s']:.2f} s, "
              f"peak {r['peak_mib']:.1f} MiB; K1 {r['K1']}, K2 {r['K2']}, plain {r['plain']}, "
              f"ELL {r['ell_products']}; {r['card']}, {r['power_limit']}", flush=True)
        check(r["device"].startswith("cuda"), f"13 {name}: ran on {r['device']}")
        check(r["dofs"] == dofs, f"13 {name}: dofs {r['dofs']} != {dofs}")
        check(r["iterations"] == oracle and r["converged"],
              f"13 {name}: {r['iterations']} iterations (converged {r['converged']}), "
              f"porotpu took {oracle}")
        check(r["guard_met"], f"13 {name}: true-residual guard failed")
        check(r["K1"] > 0 and r["K2"] > 0, f"13 {name}: K1 {r['K1']}, K2 {r['K2']} launches")
        check(r["plain"] == 0, f"13 {name}: {r['plain']} banded products took a plain version")
    print(robustness.summarize(outdir, os.path.join(ROOT, "output")), flush=True)


def multichip_phase(dev, references):
    """14: the row-sharded solve, NCCL at W=1 here, gloo at W=2 in two
    spawned ranks sharing the card, f64 and f32; then the other solve
    paths (MULTICHIP_DRIVER_RUNS), W=1 reusing ``references`` (phases 8
    and 11's unsharded solves of the same command lines)."""
    from porotpu_torch.tools import multichip

    for world, backend, dtype in MULTICHIP_RUNS:
        label = f"14 W={world} {backend} {dtype}"
        print(f"-- {label}: python -m porotpu_torch.tools.multichip --dtype {dtype}"
              + (f" --spawn {world} --backend {backend}" if world > 1 else ""), flush=True)
        if world == 1:
            out = multichip.run(1, dtype, device=dev, backend=backend)
        else:
            out = multichip.spawn(world, ["--dtype", dtype, "--backend", backend], timeout=600)
        print(multichip.report(out), flush=True)
        check(out["world"] == world and out["backend"] == backend
              and out["device"].startswith("cuda"), f"{label}: ran as {out['world']} "
              f"{out['backend']} on {out['device']}")
        check(not out["failures"], f"{label}: " + "; ".join(out["failures"]))
        check(out["K1"] > 0 and out["K2"] > 0, f"{label}: K1 {out['K1']}, K2 {out['K2']}")
        check(out["plain"] == 0, f"{label}: {out['plain']} banded products took a plain version")
        if dtype == "float32":
            check(out["K2_unsharded"] == 0, f"{label}: the unsharded f32 solve launched K2")
        if world > 1:
            check(out["exchanges_per_halo_product"] == 2,
                  f"{label}: {out['exchanges_per_halo_product']} exchanges a halo product")

    # the gloo runs (host-bound: every message through the host) in two
    # ranks each, all started now and waited on after the NCCL runs here
    import concurrent.futures
    import tempfile

    import torch

    t_phase = time.perf_counter()
    runs, gloo = [], {}
    pool = concurrent.futures.ThreadPoolExecutor(len(MULTICHIP_DRIVER_RUNS))
    logs = tempfile.TemporaryDirectory()
    for name, flags, n1, params, converges, oracle, reuse in MULTICHIP_DRIVER_RUNS:
        argv = _argv(flags)
        sets = [f"--parameter={k}={v}" for k, v in params.items()]
        if not converges:
            sets.append("--expect-unconverged")
        runs.append((name, flags, sets, argv, n1, params, converges, oracle, reuse))
        log = open(os.path.join(logs.name, name.split()[0] + ".log"), "w+")

        def gloo_run(argv=argv, sets=sets, log=log):
            t0 = time.perf_counter()
            out = multichip.spawn(2, ["--backend", "gloo", "-N", str(MULTICHIP_GLOO_N), "--reps",
                                      "0", *argv, *sets], timeout=900, output=log)
            return out, time.perf_counter() - t0

        gloo[name] = (pool.submit(gloo_run), log)

    def check_run(label, out, world, backend, flags, converges, oracle):
        print(multichip.report(out), flush=True)
        check(out["world"] == world and out["backend"] == backend
              and out["device"].startswith("cuda"), f"{label}: ran as {out['world']} "
              f"{out['backend']} on {out['device']}")
        check(not out["failures"], f"{label}: " + "; ".join(out["failures"]))
        # (d) stops at its maxiter unconverged, as the unsharded solve
        check(out["expect_converged"] == converges and out["converged"] == converges,
              f"{label}: converged {out['converged']}, expected {converges}")
        check(out["K1"] > 0, f"{label}: K1 {out['K1']}")
        check(out["plain"] == 0, f"{label}: {out['plain']} banded products took a plain version")
        if world == 1 and oracle is not None:
            check(out["iterations"] == oracle,
                  f"{label}: {out['iterations']} iterations, porotpu took {oracle}")
        if world > 1:
            check(out["exchanges_per_halo_product"] == 2,
                  f"{label}: {out['exchanges_per_halo_product']} exchanges a halo product")
        if "exact-iterative" in " ".join(flags):
            check(len(out["fp_iters"]) == out["iterations"]
                  and len(out["fp_iters_unsharded"]) == out["iterations_unsharded"],
                  f"{label}: inner FGMRES iterations {out['fp_iters']} for "
                  f"{out['iterations']} outer, unsharded {out['fp_iters_unsharded']}")

    try:
        for name, flags, sets, argv, n1, params, converges, oracle, reuse in runs:
            label = f"14{name} W=1 nccl N={n1}"
            print(f"-- {label}: python -m porotpu_torch.tools.multichip -N {n1} --reps 0 "
                  + " ".join(flags + sets), flush=True)
            t0 = time.perf_counter()
            out = multichip.run(1, "float64", device=dev, backend="nccl", N=n1, reps=0,
                                driver_args=argv, parameters=params,
                                expect_converged=converges,
                                reference=references.pop(reuse, None))
            print(f"  {label}: {time.perf_counter() - t0:.1f} s in all, the gloo runs "
                  "sharing the host and the card", flush=True)
            check_run(label, out, 1, "nccl", flags, converges, oracle)
            del out
            gc.collect()
            torch.cuda.empty_cache()
        for name, flags, sets, argv, n1, params, converges, oracle, reuse in runs:
            label = f"14{name} W=2 gloo N={MULTICHIP_GLOO_N}"
            future, log = gloo[name]
            out, seconds = future.result()
            log.seek(0)
            print(f"-- {label}: python -m porotpu_torch.tools.multichip -N {MULTICHIP_GLOO_N} "
                  f"--reps 0 {' '.join(flags + sets)} --spawn 2 --backend gloo (rank 0's "
                  f"lines: {len(log.read().splitlines())}); {seconds:.1f} s in all, started "
                  "with the others", flush=True)
            check_run(label, out, 2, "gloo", flags, converges, oracle)
    finally:
        pool.shutdown(wait=True)
        for _, log in gloo.values():
            log.close()
        logs.cleanup()
    print(f"-- 14's other solve paths: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 2

    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.ops.dia import transpose_layout
    from porotpu_torch.solvers.convergence import FieldwiseTest
    from porotpu_torch.tools import bench
    from porotpu_torch.tools import dia_microbench as mb
    from porotpu_torch.utils.roofline import stream_peak

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
    peaks = {dt: stream_peak(dt, device=dev) for dt in (torch.float32, torch.float64)}
    print(f"measured stream peak (chained triad y = s x + y over 256 MB arrays, R2-R1 delta): "
          f"f32 {peaks[torch.float32]:.1f} GB/s, f64 {peaks[torch.float64]:.1f} GB/s; "
          f"data sheet {mb.HBM_BYTES_PER_S / 1e9:.0f} GB/s", flush=True)

    # -- 1b. the ELL kernel at the benchmark cells' shapes --------------------
    ell_rec = ell_phase(dev, torch, dia_kernel, mb, peaks)

    # -- 2. main path, K1: swelling-3d N=13 f32, one step ------------------
    f32 = bench.build_problem("float32", device=dev, cache_dir=None)
    dofs, padded = f32.W.num_dofs, f32.padded_sizes
    print(f"dofs={dofs} padded sizes={padded}")
    check(dofs == 120842, f"dofs {dofs} != 120842")
    check(padded == (59136, 59136, 2816), f"padded sizes {padded}")
    counts32, launches32 = path_run("float32", f32, dev, torch, dia_kernel, bench,
                                    peaks[torch.float32])
    check(counts32["dia_mv"] > 0, "K1 was never launched on the main path")
    check(counts32["dia_rmv"] == 0, "K2 ran on the f32 path, whose transposes read dataT")
    check(counts32["plain"] == 0, f"{counts32['plain']} banded products took a plain version")
    sets1 = k1_sets(f32)
    sets2 = {("f32", k): v for k, v in k2_sets(f32).items()}
    print(f"device memory allocated before the f64 path: "
          f"{torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB")

    # -- 3. K2's path: swelling-3d N=13 f64, one step -----------------------
    print("-- f64 (K2 path)", flush=True)
    f64 = bench.build_problem("float64", device=dev, cache_dir=None)
    counts64, launches64 = path_run("float64", f64, dev, torch, dia_kernel, bench,
                                    peaks[torch.float64])
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

    # -- 3b. CastPC: the f64 solve with the PC built in f32 -----------------
    print("-- f64 solve, f32 PC (CastPC; bench.py's f64 datapoint)", flush=True)
    cast = bench.build_problem("float64", pc_dtype="float32", device=dev, cache_dir=None)
    counts_c, launches_c = path_run("float64, PC in float32", cast, dev, torch, dia_kernel,
                                    bench, peaks[torch.float64])
    check(type(cast.pc).__name__ == "CastPC", "pc dtype float32 built no CastPC")
    check(cast.iteration_log == [9],
          f"CastPC: {cast.iteration_log} iterations, BENCH_r05's f64 datapoint took 9")
    by_dtype = collections.Counter()
    for (kernel, dt, _, _), n in launches_c.items():
        by_dtype[kernel, dt] += n
    print("CastPC launches by kernel and dtype: "
          + ", ".join(f"{k} {dt}={n}" for (k, dt), n in sorted(by_dtype.items())))
    check(by_dtype["dia_mv", "float32"] > 0, "CastPC: K1 never ran on the f32 PC payload")
    check(by_dtype["dia_rmv", "float64"] > 0,
          "CastPC: K2 never ran on the f64 operator's Transposed rows")
    check(by_dtype["dia_rmv", "float32"] == 0,
          "CastPC: K2 ran in f32, where transposes read dataT")
    check(counts_c["plain"] == 0, f"CastPC: {counts_c['plain']} plain products")

    # -- 3c. f64 accuracy from f32 solves: bench.py's f64-IR datapoint -------
    print("-- f64-IR: f32 solves against the f64 true residual", flush=True)
    dia_kernel.reset_counts()
    ir = bench.run_bench_ir(f32, cast)
    counts_ir = dict(dia_kernel.COUNTS)
    first = ir["first"]
    print(f"IR: {first['passes']} passes, f32 iterations {first['f32_iters']}, true-f64 "
          f"fieldwise abs={first['abs']:.3e} rel={first['rel']:.3e} (BENCH_r05: 1 pass, 9 "
          f"iterations, abs 7.223e-09); timed runs (s): "
          + ", ".join(f"{t:.5f}" for t in ir["times_s"])
          + f", {ir['passes']} passes, {ir['iters']} iterations; counts "
          + ", ".join(f"{k}={v}" for k, v in counts_ir.items()), flush=True)
    check(1 <= first["passes"] <= bench.IR_PASSES and 1 <= ir["passes"] <= bench.IR_PASSES,
          "IR took no pass or more than its passes")
    check(ir["guard_abs"] <= bench.IR_ATOL or ir["guard_rel"] <= bench.IR_RTOL,
          "IR's timed run missed the f64 tolerance")
    check(counts_ir["dia_mv"] > 0 and counts_ir["plain"] == 0,
          f"IR: K1 {counts_ir['dia_mv']} launches, {counts_ir['plain']} plain products")
    del f32, cast  # the problems' solve closures hold cycles: collect them
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
            flops=2 * entries, dtype=dtype, launches=path_launches[tag].get(key, 0),
        )
        record[kernel, name, tag] = rec
        return rec

    def report(label, rec, rel, extra=""):
        share = mb.shares(rec["ms"], rec["nbytes"], rec["flops"], rec["dtype"],
                          peaks[rec["dtype"]])
        print(f"{label}: err {rel:.2e}; cold {rec['ms']:.4f} ms "
              f"({share}, {rec['nbytes'] / 1e6:.1f} MB), "
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
        p = bench.build_problem("float64", 3, device=dev if where == "cuda" else "cpu",
                                cache_dir=None)
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
    mbrec = mb.run(peak_gbps=peaks[torch.float32])
    launches_k3 = dia_kernel.COUNTS["dia_mv_padded"]
    mb.report(mbrec)
    check(launches_k3 > 0, "K3 was never launched by the microbench")

    # -- 8. the reference drivers' path, f64 --------------------------------
    from porotpu_torch.drivers import footing, swelling
    from porotpu_torch.ops.sparse import ELL_PRODUCTS
    from porotpu_torch.tools import multichip

    # the inner FGMRES iterations of each fgmres+fs apply, from here on
    inner_iters = multichip.inner_fgmres_counts().__enter__()
    drivers_by_name = {"swelling": swelling, "footing": footing}

    # phase 14 reuses these runs' unsharded solves
    REUSED = {reuse for *_, reuse in MULTICHIP_DRIVER_RUNS if reuse}
    references = {}
    held, mismatches = [], []
    for label, drv, argv, dofs, oracle, k2 in DRIVER_RUNS:
        out = driver_run(label, drivers_by_name[drv], argv, dofs, oracle, k2, dev, torch,
                         dia_kernel, ELL_PRODUCTS, inner_iters, FieldwiseTest, mb, peaks)
        if label == "footing_inexact":  # the ELL kernel's main path: footing's ELL blocks
            ell_launches = out["ell_counts"]["ell_mv"] + out["ell_counts"]["ell_rmv"]
            check(ell_launches > 0, f"{label}: the ELL kernel was never launched")
        pc = out["problem"].pc
        if label == "swelling_exact":
            check(pc.solve_s.kind == "lu" and pc.solve_fp.kind == "lu",
                  "petsc-options-exact did not build dense-LU solid and fp solves")
        if label == "swelling_3way_exact":
            kinds = [s.kind for s in (pc.solve_s, pc.solve_f, pc.solve_p, pc.solve_diff)]
            check(kinds == ["lu"] * 4, f"3-way petsc-options-exact built inner kinds {kinds}")
        if label.endswith("qexact"):
            # every block falls back from lu to 60 cg+amg iterations; the
            # 2-way fp block is the fgmres+fs solve
            kinds = [(s.kind, s.iters) for s in (
                [pc.solve_s, pc.solve_f, pc.solve_p, pc.solve_diff] if pc.three_way
                else [pc.solve_s, pc.solve_fp.mods["fs"].solve_f])]
            want = [("cg+amg", 60)] * 4 if pc.three_way else [("cg+amg", 60), ("cg+amg", 20)]
            check(kinds == want, f"{label}: inner solves {kinds}, expected {want}")
            if not pc.three_way:
                check(pc.solve_fp.kind == "fgmres+fs" and pc.solve_fp.iters == 60,
                      f"{label}: fp solve {pc.solve_fp.kind} x {pc.solve_fp.iters}")
                check(len(out["fp_iters"]) == sum(out["iterations"])
                      and 0 < max(out["fp_iters"]) <= 60,
                      f"{label}: inner FGMRES iterations {out['fp_iters']}")
        check(pc.three_way == ("3way" in label), f"{label}: three_way is {pc.three_way}")
        del pc
        if label in REUSED:
            references[label] = multichip.reference_of(out["problem"], out["fp_iters"],
                                                      out["counts"])
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
        hold_set(key, offs, ne, vec, dev, torch, dia_kernel, mb, rng, peaks)

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

    # -- 10. AMG without coordinates: greedy aggregation ----------------------
    greedy_phase(swelling, dev, torch, dia_kernel, ELL_PRODUCTS)

    # -- 11. outer cg, AAR, Anderson acceleration, the subsystem drivers -------
    outer_phase(dev, torch, dia_kernel, ELL_PRODUCTS, inner_iters, FieldwiseTest, mb, peaks, rng,
                mismatches, references, REUSED)
    check(not mismatches, "; ".join(mismatches))

    # -- 12. the solver cache, export and resume, inner monitors --------------
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        bench_cache_phase(dev, torch, dia_kernel, bench, tmp, smi)
        gc.collect()
        torch.cuda.empty_cache()
        resume_phase(dev, torch, dia_kernel, FieldwiseTest, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        monitor_phase(dev, torch, dia_kernel)
        gc.collect()
        torch.cuda.empty_cache()

        # -- 13. the robustness grid's runner ---------------------------------
        grid_phase(tmp)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. the row-sharded solve -------------------------------------------
    multichip_phase(dev, references)
    del references
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
        {"name": "ell_mv", "route": "cuda", "source": "porotpu_torch/csrc/ell_mv.cu",
         "replaces": None, "launches": ell_launches, "max_abs_err": ell_rec["err"],
         "ms": ell_rec["ms"], "plain_ms": ell_rec["plain_ms"], "bound_ms": ell_rec["bound_ms"],
         "bound_by": ell_rec["bound_by"], "library_ms": ell_rec["library_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The sharded solve over a row mesh, one time step, against the unsharded one.

    python -m porotpu_torch.tools.multichip                          # NCCL, one rank
    python -m porotpu_torch.tools.multichip --spawn 2 --backend gloo # two ranks sharing one card
    torchrun --nproc-per-node 4 -m porotpu_torch.tools.multichip     # NCCL, a rank a card
    python -m porotpu_torch.tools.multichip --spawn 4 --device cpu   # gloo on the host
    python -m porotpu_torch.tools.multichip -N 80 --solver-type aar  # the swelling driver's problem
    python -m porotpu_torch.tools.multichip -N 40 --solver-type cg --parameter "solver maxiter=20" \
        --expect-unconverged
    torchrun --nproc-per-node 4 -m porotpu_torch.tools.multichip --pairs 3   # split against unsplit

By default the port's counterpart of ``__graft_entry__.py:dryrun_multichip``
(:54-160): swelling N=40 with the 3-way block preconditioner and inexact
(hypre: cg+amg) inner solves, rtol 1e-5, atol 1e-6, maxiter 60, ``pad
multiple`` the world size W, one step.  Given any of the swelling
driver's flags (``--petsc-options``, ``--solver-type``,
``--inner-accel-order``, ``--pc-type``), the problem is the one that
driver builds from ``-N`` and those flags (``drivers/swelling.py:setup``),
with ``pad multiple`` W and the ``--parameter`` overrides: at W=1 the
driver's own run, whose porotpu count is on record.  Every rank builds the host setup,
keeps its slabs (``Poromechanics.create_solver(mesh)``) and solves; rank 0
also solves the same padded problem unsharded.  Printed by rank 0: W, the
backend, dofs, the iterations and convergence of both solves, the true
residual's field-wise guard, x against the unsharded x, the median solve
time of each (``--reps`` solves, the rank's device synchronized), the
launches of K1 and K2 and the plain products of the sharded solve, and
its collectives: exchanges (point-to-point messages, per halo product),
all-reduces and all-gathers with the largest one's length.  An all-gather
longer than the largest padded field fails the run (porotpu's "no
system-scale all-gather" rule, :121-155), as do a count that differs from
the unsharded one, x off the unsharded x by more than ``X_RTOL`` and a
missed guard.  The guard is the true residual's field-wise test of the
gathered sharded x through the unsharded operator, so a wrong halo
product cannot vouch for itself.  Both solves must converge, unless the
run declares that both stop unconverged at their maxiter
(``--expect-unconverged``, ``run(expect_converged=False)``: outer cg on
the nonsymmetric system); such a run prints the guard and is held to
the count, the stop and x.  The inner
FGMRES iterations of each ``fgmres+fs`` apply are recorded for both
solves, and the halo messages across each boundary between neighbouring
ranks.  ``run(reference=...)`` takes the unsharded solve from a caller
that already ran it (chip_smoke.py's driver phases).  ``--pairs K``
then times K pairs of sharded solves, one with the halo matvecs'
interior launch under the exchange and one waiting first (the mesh's
``halo_split`` set for each, the pair's order alternating), to compare
the two on several cards.  The last line is the result as JSON.

``--spawn W`` starts W ranks as child processes of this one (a
``file://`` rendezvous in a temporary directory); under torchrun each
rank reads RANK, WORLD_SIZE and LOCAL_RANK.  It runs on the card (rank r
on ``cuda:<LOCAL_RANK>``, NCCL unless ``--backend gloo``), unless
``--device cpu`` (gloo).  Build the kernels before spawning ranks that
share a machine, so that no two run nvcc at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# __graft_entry__.py:dryrun_multichip's problem
PROBLEM_N = 40
OVERRIDES = {
    "pc type": "diagonal 3-way",
    "inner pc type": "hypre",
    "solver rtol": 1e-5,
    "solver atol": 1e-6,
    "solver maxiter": 60,
}
# x against the unsharded x, relative: f64 (porotpu's bound,
# tests/test_parallel.py:76) and f32.  In f32 the sharded solve runs K2
# where the unsharded one runs K1 on dataT, and that rounding moves x by
# 3.5e-4 to 1.4e-3 at rtol 1e-5 (gloo W=2 and NCCL W=1 on an H100); an f32
# solve is 2.8e-2 from the f64 one, so a limit of 5e-3 tells the two apart
X_RTOL = {"float64": 1e-8, "float32": 5e-3}


def parse_parameters(items):
    """``["solver maxiter=20", ...]`` -> {"solver maxiter": 20}: ints, then
    floats, else strings."""
    out = {}
    for item in items or ():
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"--parameter {item!r}: expected KEY=VALUE")
        for cast in (int, float, str):
            try:
                out[key.strip()] = cast(val.strip())
                break
            except ValueError:
                continue
    return out


def build_problem(W, N, dtype, device, driver_args=None, parameters=None):
    """The padded problem (``pad multiple`` W) on ``device``: dryrun's with
    no driver flags, else the swelling driver's ``setup``."""
    from porotpu_torch.drivers import swelling
    from porotpu_torch.models import benchmarks

    parameters = dict(parameters or {})
    if not driver_args:
        ov = dict(OVERRIDES, **{"pad multiple": W, "dtype": dtype}, **parameters)
        return benchmarks.swelling(N, overrides=ov, device=device)
    argv = ["-N", str(N), *driver_args, "--dtype", dtype, "--device", device.type]
    return swelling.setup(argv, overrides={"pad multiple": W, **parameters})


class inner_fgmres_counts:
    """Record the iterations of each inner ``fgmres+fs`` apply while active
    (``__enter__`` returns the list it appends to)."""

    def __enter__(self):
        from porotpu_torch.precond import inner

        self.inner, self.fgmres, self.iters = inner, inner.fgmres, []

        def counted(*args, **kwargs):
            res = self.fgmres(*args, **kwargs)
            self.iters.append(res.iters)
            return res

        inner.fgmres = counted
        return self.iters

    def __exit__(self, *exc):
        self.inner.fgmres = self.fgmres


def reference_of(problem, fp_iters=(), counts=None):
    """The unsharded solve of a problem its caller solved one step of (the
    count, x, and the operator and right-hand side the guard needs), for
    ``run(reference=...)``."""
    res = problem.last_result
    counts = counts or {}
    return {
        "iterations": res.iters, "converged": bool(res.converged),
        "x": problem.unpadded_solution(), "A": problem.A_dev, "b": problem.last_rhs,
        "padded_sizes": problem.padded_sizes, "solve_s": problem.t_solve_total,
        "K1": counts.get("dia_mv"), "K2": counts.get("dia_rmv"), "fp_iters": list(fp_iters),
    }


def _median_solve(problem, b, reps, torch):
    """(result of the last solve, median seconds) of ``reps`` solves of one
    right-hand side from zero; (None, None) for no solve."""
    if reps <= 0:
        return None, None
    times, res = [], None
    for _ in range(reps):
        if problem.device.type == "cuda":
            torch.cuda.synchronize(problem.device)
        t0 = time.perf_counter()
        res = problem._solve(b, torch.zeros_like(b))
        if problem.device.type == "cuda":
            torch.cuda.synchronize(problem.device)
        times.append(time.perf_counter() - t0)
    return res, sorted(times)[len(times) // 2]


def _split_pairs(problem, b, mesh, pairs, torch):
    """Seconds of ``pairs`` pairs of sharded solves, (split, unsplit): the
    mesh's ``halo_split`` set for each solve, the split one first in the
    even pairs and second in the odd ones; the mesh's own setting after."""
    own, times = mesh.halo_split, []
    try:
        for i in range(pairs):
            pair = {}
            for split in ((True, False) if i % 2 == 0 else (False, True)):
                mesh.halo_split = split
                pair[split] = _median_solve(problem, b, 1, torch)[1]
            times.append((pair[True], pair[False]))
    finally:
        mesh.halo_split = own
    return times


def collectives_summary(counts, products, padded_sizes):
    """Exchanges, all-reduces and all-gathers of one solve from
    ``sharding.COLLECTIVES`` and ``dia.MESH_PRODUCTS``."""
    exch = sum(n for (op, _), n in counts.items() if op == "exchange")
    halo = sum(n for (kind, _, emb), n in products.items() if kind == "halo" and not emb)
    ag = [length for (op, length), n in counts.items() if op == "all_gather" for _ in range(n)]
    return {
        "exchanges": exch,
        "halo_products": halo,
        "exchanges_per_halo_product": exch / halo if halo else 0.0,
        "mesh_products": {f"{k}/{p}{'/emb' if e else ''}": n for (k, p, e), n in products.items()},
        "allreduces": sum(n for (op, _), n in counts.items() if op == "allreduce"),
        "all_gathers": len(ag),
        "all_gather_max": max(ag, default=0),
        "field_max": max(padded_sizes),
    }


def run(world=None, dtype="float64", device="cuda", backend=None, rank=None,
        init_method=None, N=PROBLEM_N, reps=3, timeout=None, driver_args=None,
        parameters=None, expect_converged=True, pairs=0, reference=None):
    """One rank's part: the sharded solve and, on rank 0, the unsharded one
    (or ``reference``, from ``reference_of``) and the checks.
    ``expect_converged=False``: both solves are to stop unconverged at
    their maxiter.  ``pairs``: as ``--pairs``.  Returns the result dict on
    rank 0, None elsewhere.  Makes the process group and destroys it at
    the end."""
    import numpy as np
    import torch

    from porotpu_torch.ops import dia, dia_kernel
    from porotpu_torch.parallel import sharding
    from porotpu_torch.solvers.convergence import FieldwiseTest

    kw = {} if timeout is None else {"timeout": timeout}
    mesh = sharding.solver_mesh(world, device, rank=rank, init_method=init_method,
                                backend=backend, **kw)
    try:
        W = mesh.world
        if mesh.device.type == "cpu":
            # ranks on one host share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // W))
        problem = build_problem(W, N, dtype, mesh.device, driver_args, parameters)
        problem.create_solver(mesh)
        problem.first_timestep = False
        t = problem.t0 + problem.parameters["dt"]
        b = problem.get_rhs(t)
        dia_kernel.reset_counts()
        sharding.reset_collectives()
        dia.MESH_PRODUCTS.clear()
        t0 = time.perf_counter()
        with inner_fgmres_counts() as fp_iters:
            res = problem._solve(b, torch.zeros_like(b))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t_counted = time.perf_counter() - t0
        counts = dict(dia_kernel.COUNTS)
        coll = collectives_summary(sharding.COLLECTIVES, dia.MESH_PRODUCTS,
                                   problem.padded_sizes)
        coll["per_kind"] = {f"{op}:{n}": c for (op, n), c in sorted(sharding.COLLECTIVES.items())}
        # the halo messages across each boundary between neighbouring ranks
        sent = torch.tensor([sharding.SENT.get(r, 0) for r in range(W)], device=mesh.device)
        sent = mesh.all_gather(sent).reshape(W, W).tolist() if W > 1 else [[0]]
        coll["exchanges_by_boundary"] = [sent[r][r + 1] + sent[r + 1][r] for r in range(W - 1)]
        problem.sol = res.x
        x = problem.unpadded_solution()
        xg = sharding.gather_vector(res.x, mesh, problem.local_sizes)
        # reps 0: the counted solve's own time
        t_sharded = _median_solve(problem, b, reps, torch)[1] or t_counted
        split_pairs = _split_pairs(problem, b, mesh, pairs, torch)
        out = None
        if mesh.rank == 0:
            if reference is None:
                ref = build_problem(W, N, dtype, mesh.device, driver_args, parameters)
                ref.create_solver()
                ref.first_timestep = False
                ref.last_rhs = ref.get_rhs(t)
                dia_kernel.reset_counts()
                t0 = time.perf_counter()
                with inner_fgmres_counts() as fp_iters1:
                    ref.last_result = ref._solve(ref.last_rhs, torch.zeros_like(ref.last_rhs))
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                t_counted1 = time.perf_counter() - t0
                counts1 = dict(dia_kernel.COUNTS)
                ref.sol = ref.last_result.x
                ref.t_solve_total = _median_solve(ref, ref.last_rhs, reps, torch)[1] or t_counted1
                reference = reference_of(ref, fp_iters1, counts1)
                reference["reused"] = False
            b1, A1 = reference["b"], reference["A"]
            x1 = np.asarray(reference["x"])
            # the true residual of the sharded x through the unsharded operator
            fw = FieldwiseTest.from_sizes(reference["padded_sizes"], b1)
            with torch.inference_mode():
                ea, er = (v.item() for v in fw.errors(b1 - A1.matvec(xg.to(b1.device))))
            p = problem.parameters
            guard = ea < float(p["solver atol"]) or er < float(p["solver rtol"])
            x_rel = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
            out = {
                "world": W, "backend": mesh.backend, "device": str(mesh.device),
                "card": torch.cuda.get_device_name(mesh.device)
                if mesh.device.type == "cuda" else "cpu",
                "dtype": dtype, "N": N, "dofs": problem.W.num_dofs,
                "problem": " ".join(driver_args) if driver_args else "dryrun_multichip",
                "parameters": dict(parameters or {}),
                "split": bool(mesh.halo_split), "split_pairs": split_pairs,
                "padded": list(problem.padded_sizes),
                "iterations": res.iters, "converged": bool(res.converged),
                "expect_converged": bool(expect_converged),
                "iterations_unsharded": reference["iterations"],
                "converged_unsharded": reference["converged"],
                "reference_reused": reference.get("reused", True),
                "guard_abs": ea, "guard_rel": er, "guard_met": bool(guard),
                "x_rel": x_rel, "x_rtol": X_RTOL[dtype],
                "solve_s": t_sharded, "solve_s_unsharded": reference["solve_s"],
                "K1": counts["dia_mv"], "K2": counts["dia_rmv"], "plain": counts["plain"],
                "K1_unsharded": reference["K1"], "K2_unsharded": reference["K2"],
                "fp_iters": list(fp_iters), "fp_iters_unsharded": reference["fp_iters"],
                **coll,
                "foreign": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "porotpu")),
            }
            failures = check(out)
            out["failures"] = failures
        # every rank waits for rank 0's unsharded solve before the group ends
        mesh.barrier()
        return out
    finally:
        mesh.close()


def check(out):
    """The run's failures, as messages (none: it passed)."""
    fails = []
    want = out["expect_converged"]
    if (out["iterations"] != out["iterations_unsharded"] or out["converged"] != want
            or out["converged_unsharded"] != want):
        fails.append(f"{out['iterations']} iterations (converged {out['converged']}), "
                     f"unsharded {out['iterations_unsharded']} (converged "
                     f"{out['converged_unsharded']}); expected to converge: {want}")
    if not out["x_rel"] <= out["x_rtol"]:
        fails.append(f"x off the unsharded x by {out['x_rel']:.3e} > {out['x_rtol']:g}")
    if want and not out["guard_met"]:
        fails.append(f"true-residual guard missed (abs {out['guard_abs']:.3e}, "
                     f"rel {out['guard_rel']:.3e})")
    if out["foreign"]:
        fails.append(f"imported {out['foreign']}")
    if out["all_gather_max"] > out["field_max"]:
        fails.append(f"an all-gather of {out['all_gather_max']} > the largest field "
                     f"{out['field_max']}")
    return fails


def report(out) -> str:
    """Rank 0's lines for a result."""
    reused = " (reused: the caller's solve, its counts over the whole step)" \
        if out["reference_reused"] else ""
    lines = [
        f"multichip: W={out['world']} {out['backend']} on "
        f"{out['device']} ({out['card']}), {out['dtype']}, swelling N={out['N']} "
        f"[{out['problem']}] {out['parameters'] or ''}, dofs {out['dofs']}, padded "
        f"{out['padded']}, halo split {out['split']}",
        f"  sharded {out['iterations']} iterations (converged {out['converged']}), unsharded "
        f"{out['iterations_unsharded']} (converged {out['converged_unsharded']}){reused}; "
        f"guard (unsharded operator) abs {out['guard_abs']:.3e} rel {out['guard_rel']:.3e} "
        f"met {out['guard_met']}; |x - x_unsharded| / |x_unsharded| = {out['x_rel']:.3e} "
        f"(limit {out['x_rtol']:g})",
        f"  median solve: sharded {out['solve_s']:.4f} s, unsharded {out['solve_s_unsharded']:.4f}"
        f" s (ratio {out['solve_s'] / out['solve_s_unsharded']:.2f})",
        f"  launches: K1 {out['K1']}, K2 {out['K2']}, plain {out['plain']} (unsharded: K1 "
        f"{out['K1_unsharded']}, K2 {out['K2_unsharded']})",
        f"  collectives a solve: {out['exchanges']} exchanges (rank 0's; across each boundary "
        f"between neighbours {out['exchanges_by_boundary']}) over {out['halo_products']} "
        f"halo products "
        f"({out['exchanges_per_halo_product']:.2f} each), {out['allreduces']} "
        f"all-reduces, {out['all_gathers']} all-gathers (largest {out['all_gather_max']}, "
        f"largest field {out['field_max']}); products {out['mesh_products']}",
    ]
    if out["split_pairs"]:
        split, unsplit = zip(*out["split_pairs"])
        lines.append(f"  pairs of sharded solves, split / unsplit s: "
                     + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in out["split_pairs"])
                     + f"; medians {statistics.median(split):.4f} / "
                     f"{statistics.median(unsplit):.4f}")
    if out["fp_iters"] or out["fp_iters_unsharded"]:
        lines.append(f"  inner fgmres+fs iterations an apply: sharded {out['fp_iters']}, "
                     f"unsharded {out['fp_iters_unsharded']}")
    if out["failures"]:
        lines.append("  FAILED: " + "; ".join(out["failures"]))
    return "\n".join(lines)


def spawn(world, args_list, env=None, timeout=None, output=None):
    """Start ``world`` ranks of this tool as child processes (rank 0's
    output shown, or written to the file object ``output``; the others'
    discarded) and return rank 0's result.  If a rank fails, the error
    holds the tails of the ranks' errors, rank 0's output in ``output``
    among them."""
    import torch

    ndev = torch.cuda.device_count() if "--device" not in args_list else 0
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs, logs = [], []
        for r in range(world):
            e = dict(os.environ if env is None else env)
            e.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
            e["LOCAL_RANK"] = str(r % ndev) if ndev else "0"
            cmd = [sys.executable, "-m", "porotpu_torch.tools.multichip", "--rank", str(r),
                   "--world", str(world), "--init", init, "--result", result, *args_list]
            logs.append(open(os.path.join(tmp, f"rank{r}.err"), "w+"))
            procs.append(subprocess.Popen(
                cmd, env=e, stdout=output if r == 0 else subprocess.DEVNULL,
                stderr=(output and subprocess.STDOUT) if r == 0 else logs[-1],
            ))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        errs = []
        for log in logs:
            log.seek(0)
            errs.append(log.read()[-4000:])
            log.close()
        if any(rcs):
            if output is not None:
                output.flush()
                output.seek(0)
                errs[0] = output.read()[-4000:]
            raise RuntimeError(f"multichip ranks exited {rcs}: " + "".join(errs))
        with open(result) as f:
            return json.load(f)


# the swelling driver's flags the tool passes on
DRIVER_FLAGS = ("--petsc-options", "--solver-type", "--inner-accel-order", "--pc-type")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, help="start this many ranks as child processes")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("-N", type=int, default=PROBLEM_N)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed solves after the counted one (0: time the counted one)")
    ap.add_argument("--timeout", type=float, help="seconds a collective may wait")
    ap.add_argument("--expect-unconverged", action="store_true",
                    help="both solves are to stop unconverged at their maxiter")
    ap.add_argument("--pairs", type=int, default=0,
                    help="then time this many pairs of sharded solves, split and unsplit")
    ap.add_argument("--parameter", action="append", default=[], metavar="KEY=VALUE",
                    help="a parameter override, e.g. 'solver maxiter=20' (repeatable)")
    for flag in DRIVER_FLAGS:
        ap.add_argument(flag, help="the swelling driver's flag")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    driver_args = []
    for flag in DRIVER_FLAGS:
        val = getattr(args, flag[2:].replace("-", "_"))
        if val is not None:
            driver_args += [flag, val]
    common = ["--dtype", args.dtype, "-N", str(args.N), "--reps", str(args.reps), *driver_args]
    for item in args.parameter:
        common += ["--parameter", item]
    if args.device != "cuda":
        common += ["--device", args.device]
    if args.backend:
        common += ["--backend", args.backend]
    if args.timeout:
        common += ["--timeout", str(args.timeout)]
    if args.expect_unconverged:
        common += ["--expect-unconverged"]
    if args.pairs:
        common += ["--pairs", str(args.pairs)]
    if args.spawn:
        out = spawn(args.spawn, common)
    else:
        out = run(args.world, args.dtype, args.device, args.backend, args.rank, args.init,
                  args.N, args.reps, args.timeout, driver_args or None,
                  parse_parameters(args.parameter), not args.expect_unconverged, args.pairs)
        if out is None:
            return 0
        if args.result:  # a spawned rank 0: the parent prints
            with open(args.result, "w") as f:
                json.dump(out, f)
            return 0
    print(report(out), flush=True)
    print(json.dumps(out), flush=True)
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())

"""The sharded solve over a row mesh, one time step, against the unsharded one.

    python -m porotpu_torch.tools.multichip                          # NCCL, one rank
    python -m porotpu_torch.tools.multichip --spawn 2 --backend gloo # two ranks sharing one card
    torchrun --nproc-per-node 4 -m porotpu_torch.tools.multichip     # NCCL, a rank a card
    python -m porotpu_torch.tools.multichip --spawn 4 --device cpu   # gloo on the host

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``
(:54-160): swelling N=40 with the 3-way block preconditioner and inexact
(hypre: cg+amg) inner solves, rtol 1e-5, atol 1e-6, maxiter 60, ``pad
multiple`` the world size W, one step.  Every rank builds the host setup,
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
product cannot vouch for itself.  The last line is the result as JSON.

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


def _median_solve(problem, b, reps, torch):
    """(result of the last solve, median seconds) of ``reps`` solves of one
    right-hand side from zero."""
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
        init_method=None, N=PROBLEM_N, reps=3, timeout=None):
    """One rank's part: the sharded solve and, on rank 0, the unsharded one
    and the checks.  Returns the result dict on rank 0, None elsewhere.
    Makes the process group and destroys it at the end."""
    import numpy as np
    import torch

    from porotpu_torch.models import benchmarks
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
        ov = dict(OVERRIDES, **{"pad multiple": W, "dtype": dtype})
        problem = benchmarks.swelling(N, overrides=ov, device=mesh.device)
        problem.create_solver(mesh)
        problem.first_timestep = False
        t = problem.t0 + problem.parameters["dt"]
        b = problem.get_rhs(t)
        dia_kernel.reset_counts()
        sharding.reset_collectives()
        dia.MESH_PRODUCTS.clear()
        res = problem._solve(b, torch.zeros_like(b))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        counts = dict(dia_kernel.COUNTS)
        coll = collectives_summary(sharding.COLLECTIVES, dia.MESH_PRODUCTS,
                                   problem.padded_sizes)
        coll["per_kind"] = {f"{op}:{n}": c for (op, n), c in sorted(sharding.COLLECTIVES.items())}
        problem.sol = res.x
        x = problem.unpadded_solution()
        xg = sharding.gather_vector(res.x, mesh, problem.local_sizes)
        _, t_sharded = _median_solve(problem, b, reps, torch)
        out = None
        if mesh.rank == 0:
            ref = benchmarks.swelling(N, overrides=ov, device=mesh.device)
            ref.create_solver()
            ref.first_timestep = False
            b1 = ref.get_rhs(t)
            dia_kernel.reset_counts()
            res1 = ref._solve(b1, torch.zeros_like(b1))
            counts1 = dict(dia_kernel.COUNTS)
            ref.sol = res1.x
            x1 = ref.unpadded_solution()
            # the true residual of the sharded x through the unsharded operator
            fw = FieldwiseTest.from_sizes(ref.padded_sizes, b1)
            ea, er = (v.item() for v in fw.errors(b1 - ref.A_dev.matvec(xg)))
            p = ref.parameters
            guard = ea < float(p["solver atol"]) or er < float(p["solver rtol"])
            _, t_one = _median_solve(ref, b1, reps, torch)
            x_rel = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
            out = {
                "world": W, "backend": mesh.backend, "device": str(mesh.device),
                "card": torch.cuda.get_device_name(mesh.device)
                if mesh.device.type == "cuda" else "cpu",
                "dtype": dtype, "N": N, "dofs": problem.W.num_dofs,
                "padded": list(problem.padded_sizes),
                "iterations": res.iters, "converged": bool(res.converged),
                "iterations_unsharded": res1.iters,
                "converged_unsharded": bool(res1.converged),
                "guard_abs": ea, "guard_rel": er, "guard_met": bool(guard),
                "x_rel": x_rel, "x_rtol": X_RTOL[dtype],
                "solve_s": t_sharded, "solve_s_unsharded": t_one,
                "K1": counts["dia_mv"], "K2": counts["dia_rmv"], "plain": counts["plain"],
                "K1_unsharded": counts1["dia_mv"], "K2_unsharded": counts1["dia_rmv"],
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
    if out["iterations"] != out["iterations_unsharded"] or not out["converged"]:
        fails.append(f"{out['iterations']} iterations (converged {out['converged']}), "
                     f"unsharded {out['iterations_unsharded']}")
    if not out["x_rel"] <= out["x_rtol"]:
        fails.append(f"x off the unsharded x by {out['x_rel']:.3e} > {out['x_rtol']:g}")
    if not out["guard_met"]:
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
    lines = [
        f"multichip: W={out['world']} {out['backend']} on {out['device']} ({out['card']}), "
        f"{out['dtype']}, swelling N={out['N']}, dofs {out['dofs']}, padded {out['padded']}",
        f"  sharded {out['iterations']} iterations (converged {out['converged']}), unsharded "
        f"{out['iterations_unsharded']} (converged {out['converged_unsharded']}); guard "
        f"(unsharded operator) abs {out['guard_abs']:.3e} rel {out['guard_rel']:.3e} met "
        f"{out['guard_met']}; |x - x_unsharded| / |x_unsharded| = {out['x_rel']:.3e} "
        f"(limit {out['x_rtol']:g})",
        f"  median solve: sharded {out['solve_s']:.4f} s, unsharded {out['solve_s_unsharded']:.4f}"
        f" s (ratio {out['solve_s'] / out['solve_s_unsharded']:.2f})",
        f"  launches: K1 {out['K1']}, K2 {out['K2']}, plain {out['plain']} (unsharded: K1 "
        f"{out['K1_unsharded']}, K2 {out['K2_unsharded']})",
        f"  collectives a solve: {out['exchanges']} exchanges over {out['halo_products']} halo "
        f"products ({out['exchanges_per_halo_product']:.2f} each), {out['allreduces']} "
        f"all-reduces, {out['all_gathers']} all-gathers (largest {out['all_gather_max']}, "
        f"largest field {out['field_max']}); products {out['mesh_products']}",
    ]
    if out["failures"]:
        lines.append("  FAILED: " + "; ".join(out["failures"]))
    return "\n".join(lines)


def spawn(world, args_list, env=None, timeout=None):
    """Start ``world`` ranks of this tool as child processes (rank 0's
    output shown, the others' discarded) and return rank 0's result."""
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
                cmd, env=e, stdout=None if r == 0 else subprocess.DEVNULL,
                stderr=None if r == 0 else logs[-1],
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
            raise RuntimeError(f"multichip ranks exited {rcs}: " + "".join(errs))
        with open(result) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, help="start this many ranks as child processes")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("-N", type=int, default=PROBLEM_N)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, help="seconds a collective may wait")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    common = ["--dtype", args.dtype, "-N", str(args.N), "--reps", str(args.reps)]
    if args.device != "cuda":
        common += ["--device", args.device]
    if args.backend:
        common += ["--backend", args.backend]
    if args.timeout:
        common += ["--timeout", str(args.timeout)]
    if args.spawn:
        out = spawn(args.spawn, common)
    else:
        out = run(args.world, args.dtype, args.device, args.backend, args.rank, args.init,
                  args.N, args.reps, args.timeout)
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

"""The paper's robustness grid on the port: outer iterations against N.

    python -m porotpu_torch.tools.robustness [CELL ...] [--ns N ...] [--outdir DIR]
                                             [--device cpu] [--cache-dir DIR]
    python -m porotpu_torch.tools.robustness --summarize [--outdir DIR] [--reference DIR]
    python -m porotpu_torch.tools.robustness --list [CELL ...]

The port's counterpart of the four files that make porotpu's table
(output/SUMMARY.md), each of which drives porotpu's own scripts:

- paper-scripts/robustness_2d.sh: the grid, 46 cells in its order and at
  its defaults (``GRID``): {swelling, footing} x {2-way, 3-way} under the
  exact (dense LU), quasi-exact and inexact options files;
- paper-scripts/fill_robustness_cells.sh: a rerun skips every cell whose
  log already holds a count, and the cells run smallest N first;
- tools/tpu_grid_cells.py: cells with parameter overrides, tagged in
  their log's header (``EXTRA_CELLS``), and a solver cache per cell
  (``<cache-dir>/torch_grid_<cell>.pkl``);
- tools/summarize_robustness.py: the table (``--summarize``), here with
  porotpu's count beside each of the port's.

CELL is a cell's name or a shell pattern over the names (``--list``);
none runs the 46 cells of the grid.  ``--ns`` runs the chosen cells at
other sizes, as the script's ``NS_*`` variables do (``--ns 2 --device
cpu`` runs the grid at N=2 on the CPU).

Each cell runs in a child process, so that it starts with a fresh CUDA
context and frees its memory when it ends: the port's driver
(``porotpu_torch.drivers.swelling`` or ``footing``: its ``setup``, given
the cell's overrides, the solve and ``print_timings``, as its ``main``)
with -N, --petsc-options, --pc-type and --time-final 0.02, one step at
t=0.10, as robustness_2d.sh:32-41 runs porotpu's.  Its output is printed as it
comes and appended to ``<outdir>/robustness-2d-<case>.out`` under
porotpu's header line, whole when the cell ends, so that runners started
in parallel on other cells never interleave their lines; a child that
exits nonzero leaves porotpu's marker ``FAILED (driver exit nonzero)``,
the run goes on with the next cell and exits nonzero at the end.  Each
cell also appends one JSON line to ``<outdir>/cells.jsonl``: dofs,
iterations, convergence, setup and solve seconds, the peak device
memory, the true-residual field-wise guard, the dispatch counts of the
solve and the card (nvidia-smi's name and power limit).

It runs on the card, and stops at once without one, unless ``--device
cpu`` is passed.
"""

from __future__ import annotations

import argparse
import fcntl
import fnmatch
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TF = 0.02  # robustness_2d.sh:26, one step of 0.1
FAILED = "FAILED (driver exit nonzero)"


class Cell(NamedTuple):
    case: str  # the log's name, robustness-2d-<case>.out
    driver: str  # swelling or footing
    N: int
    opts: str  # the options file, in the repository's root
    pc: str
    overrides: dict = {}  # parameter overrides (tools/tpu_grid_cells.py's "extra")
    tag: str = ""  # stamped into the log's header after the options file
    label: str = ""  # appended to the name of a cell with overrides

    @property
    def name(self):
        return f"{self.case}-{self.N}{self.label}"

    @property
    def header(self):
        return f"{self.driver}.py pc='{self.pc}' N={self.N} opts={self.opts} {self.tag}".rstrip()

    def argv(self, device):
        return ["-N", str(self.N), "--petsc-options", os.path.join(ROOT, self.opts),
                "--pc-type", self.pc, "--time-final", str(TF), "--device", device]


# robustness_2d.sh:10-24, its defaults
NS = {"swelling": (10, 20, 40, 80, 160), "footing": (10, 20, 40, 80)}
NS_EXACT = {"swelling": (10, 20, 40), "footing": (10, 20)}
PC_TYPES = {"swelling": ("diagonal", "diagonal 3-way"),
            "footing": ("undrained", "undrained 3-way")}
# the script's three blocks in its order: options file, case suffix, sizes
PROTOCOLS = (
    ("petsc-options-exact", "", NS_EXACT),
    ("petsc-options-exact-iterative", "-qexact", NS),
    ("petsc-options-inexact", "-inexact", NS),
)


def _grid():
    cells = []
    for opts, suffix, ns in PROTOCOLS:
        for driver in ("swelling", "footing"):
            for N in ns[driver]:
                for way, pc in zip(("2way", "3way"), PC_TYPES[driver]):
                    cells.append(Cell(f"{driver}-{way}{suffix}", driver, N, opts, pc))
    return tuple(cells)


GRID = _grid()
# tools/tpu_grid_cells.py:52-57's plan-B cell f3w-inexact-80-f32, in f64:
# footing 3-way inexact takes 196, 248 and 403 iterations over N=10-40
EXTRA_CELLS = (
    Cell("footing-3way-inexact", "footing", 80, "petsc-options-inexact", "undrained 3-way",
         {"solver maxiter": 800}, "[maxiter 800]", "-maxiter800"),
)


def select(patterns=(), ns=None):
    """The cells named by ``patterns`` (names or shell patterns; none:
    the grid), at the sizes ``ns`` when given, smallest N first and in
    the script's order within one N."""
    pool = GRID + EXTRA_CELLS
    cells = [c for c in pool if any(fnmatch.fnmatchcase(c.name, p) for p in patterns)] \
        if patterns else list(GRID)
    if patterns and not cells:
        raise SystemExit(f"no cell matches {' '.join(patterns)}; see --list")
    if ns:
        seen, sized = set(), []
        for c in cells:
            for n in ns:
                c2 = c._replace(N=n)
                if c2.name not in seen:
                    seen.add(c2.name)
                    sized.append(c2)
        cells = sized
    return sorted(cells, key=lambda c: c.N)


# -- the logs ------------------------------------------------------------------

HEADER = re.compile(r"\S+\.py pc='.*' N=(\d+) opts=(\S+)(.*)$")
SOLVED = re.compile(r"Solved time t=[\d.]+\. (\d+) iterations")
CELL_LINE = re.compile(r"---- \[Cell\] .* converged=(True|False)")


def parse(path):
    """{(N, tag): (iterations, converged)} of one log: the last step's
    count of each run, a later run of a cell replacing an earlier one
    (tools/summarize_robustness.py:parse); ``converged`` is None where
    the log does not say (porotpu's logs); a run that left no count is
    ``(None, False)`` after the FAILED marker, ``(None, None)`` without
    one (cut off)."""
    runs, key = {}, None
    with open(path) as fh:
        for line in fh:
            m = HEADER.match(line)
            if m:
                key = (int(m.group(1)), m.group(3).strip())
                runs.setdefault(key, (None, None))
                continue
            if key is None:
                continue
            m = SOLVED.search(line)
            if m:
                runs[key] = (int(m.group(1)), None)
                continue
            m = CELL_LINE.match(line)
            if m and runs[key][0] is not None:
                runs[key] = (runs[key][0], m.group(1) == "True")
            elif line.startswith(FAILED) and runs[key][0] is None:
                runs[key] = (None, False)
    return runs


def log_path(outdir, case):
    return os.path.join(outdir, f"robustness-2d-{case}.out")


def done(cell, outdir):
    """Whether the cell's log already holds a count for it."""
    path = log_path(outdir, cell.case)
    return os.path.exists(path) and (parse(path).get((cell.N, cell.tag)) or (None,))[0] is not None


def read_logs(outdir):
    """{case: parse(log)} of every robustness-2d-*.out in ``outdir``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(outdir, "robustness-2d-*.out"))):
        out[os.path.basename(path)[len("robustness-2d-"):-len(".out")]] = parse(path)
    return out


# -- the parent: one child process a cell ---------------------------------------

def card():
    """(name, power limit) of card 0, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return name, limit


def child_command(cell, device, cache_dir, record):
    return [sys.executable, "-m", "porotpu_torch.tools.robustness", "--child",
            json.dumps(cell._asdict()), "--device", device, "--cache-dir", cache_dir or "",
            "--record", record]


def _append(path, text):
    """Append ``text`` whole: the exclusive lock keeps runners in parallel
    (on other cells of the same case) from interleaving their blocks."""
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)  # released when the file closes
        fh.write(text)


def run(cells, outdir="output/torch", device="cuda", cache_dir=".cache"):
    """Run each cell not done yet in a child process; returns the names of
    the cells that failed (an empty list: every cell ran or was done)."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("robustness: torch sees no CUDA card; pass --device cpu "
                             "to run the grid on the host")
        name, limit = card()
    else:
        name, limit = None, None
    os.makedirs(outdir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    failed = []
    for cell in cells:
        if done(cell, outdir):
            print(f"[grid] {cell.name}: done, skipped", flush=True)
            continue
        block = ["\n", cell.header + "\n"]
        print("\n" + cell.header, flush=True)
        fd, record = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.Popen(child_command(cell, device, cache_dir, record), env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:  # tee, as the script's run_case
                block.append(line)
                sys.stdout.write(line)
                sys.stdout.flush()
            rc = proc.wait()
            with open(record) as fh:
                text = fh.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            os.unlink(record)
        rec = json.loads(text) if rc == 0 and text else {}
        if rc != 0:
            block.append(FAILED + "\n")
            print(FAILED, flush=True)
            failed.append(cell.name)
        _append(log_path(outdir, cell.case), "".join(block))
        rec = {"cell": cell.name, "case": cell.case, "N": cell.N, "tag": cell.tag,
               "rc": rc, "wall_s": time.perf_counter() - t0, **rec,
               "card": name, "power_limit": limit}
        _append(os.path.join(outdir, "cells.jsonl"), json.dumps(rec) + "\n")
    return failed


# -- the child: one cell --------------------------------------------------------

def run_cell(cell, device, cache_dir, record):
    """Run one cell in this process and write its record to ``record``."""
    import torch

    from ..drivers import footing, swelling
    from ..models.abstract import log
    from ..ops import dia_kernel
    from ..ops.sparse import ELL_PRODUCTS
    from ..solvers.convergence import FieldwiseTest

    drv = {"swelling": swelling, "footing": footing}[cell.driver]
    t0 = time.perf_counter()
    problem = drv.setup(cell.argv(device), cell.overrides)
    cuda = problem.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(problem.device)
    restored = False
    if cache_dir:
        path = os.path.join(cache_dir, f"torch_grid_{cell.name}.pkl")
        problem.parameters["solver cache path"] = path  # create_solver saves there
        restored = problem.try_load_solver_cache(path)
        if restored:
            log(f"---- [Cache] solver restored from {path} in {problem.t_setup:.2f}s")
    if not restored:
        problem.create_solver()
        problem.first_timestep = False
    setup_s = time.perf_counter() - t0
    dia_kernel.reset_counts()
    ELL_PRODUCTS.clear()
    its = problem.solve()
    counts = dict(dia_kernel.COUNTS)
    ell = sum(ELL_PRODUCTS.values())
    problem.print_timings()
    b = problem.last_rhs
    with torch.inference_mode():
        fw = FieldwiseTest.from_sizes(problem.padded_sizes, b)
        ea, er = (float(v) for v in fw.errors(b - problem.A_dev.matvec(problem.sol)))
    met = ea < float(problem.parameters["solver atol"]) or er < float(
        problem.parameters["solver rtol"])
    peak = torch.cuda.max_memory_allocated(problem.device) / 2**20 if cuda else None
    rec = {"dofs": problem.W.num_dofs, "iterations": its[-1],
           "converged": bool(problem.last_result.converged), "setup_s": setup_s,
           "restored": restored, "solve_s": problem.t_solve_total,
           "peak_mib": peak, "guard_abs": ea, "guard_rel": er, "guard_met": met,
           "K1": counts["dia_mv"], "K2": counts["dia_rmv"], "plain": counts["plain"],
           "ell_products": ell, "device": str(problem.device)}
    log("---- [Cell] {}: dofs={} iterations={} converged={} guard abs={:.3e} rel={:.3e} "
        "{}; setup {:.2f}s{}, solve {:.2f}s, peak {} MiB; K1 {}, K2 {}, plain {}, ELL {}".format(
            cell.name, rec["dofs"], its[-1], rec["converged"], ea, er,
            "met" if met else "NOT met", setup_s, " (restored)" if restored else "",
            rec["solve_s"], "n/a" if peak is None else f"{peak:.1f}", rec["K1"], rec["K2"],
            rec["plain"], ell))
    with open(record, "w") as fh:
        json.dump(rec, fh)


# -- the table -------------------------------------------------------------------

def plain_table(logs):
    """tools/summarize_robustness.py's table of one directory's logs."""
    counts = {case: {n: it for (n, _), (it, _) in sorted(runs.items()) if it is not None}
              for case, runs in logs.items()}
    counts = {case: runs for case, runs in counts.items() if runs}
    ns = sorted({n for runs in counts.values() for n in runs})
    lines = ["# Robustness sweep: outer Krylov iterations vs mesh size N", "",
             "| case | " + " | ".join(f"N={n}" for n in ns) + " |",
             "|" + "---|" * (len(ns) + 1)]
    for case, runs in counts.items():
        lines.append(f"| {case} | " + " | ".join(str(runs.get(n, "—")) for n in ns) + " |")
    return lines


def _count(it, conv):
    return f"{it}" + ("*" if conv is False else "")


def compared_table(port, ref):
    """The port's count beside porotpu's in each cell: ``=`` they match,
    ``≠`` they differ, ``port-only`` porotpu has none; a tagged run
    follows its cell's count."""
    ns = sorted({n for t in (port, ref) for runs in t.values() for n, _ in runs})
    lines = ["| case | " + " | ".join(f"N={n}" for n in ns) + " |",
             "|" + "---|" * (len(ns) + 1)]
    for case in sorted(set(port) | set(ref)):
        mine = port.get(case, {})
        theirs = {n: it for (n, _), (it, _) in ref.get(case, {}).items() if it is not None}
        texts = []
        for n in ns:
            it, conv = mine.get((n, ""), (None, None))
            r = theirs.get(n)
            if it is None:
                text = ("FAILED" if conv is False else "—") + (f" ({r})" if r else "")
            elif r is None:
                text = f"{_count(it, conv)} port-only"
            else:
                text = f"{_count(it, conv)} {'=' if it == r else '≠'} {r}"
            for (n2, tag), (it2, conv2) in sorted(mine.items()):
                if n2 == n and tag:
                    text += f"; {'FAILED' if it2 is None else _count(it2, conv2)} {tag}"
            texts.append(text)
        lines.append(f"| {case} | " + " | ".join(texts) + " |")
    return lines


def records(outdir):
    """The last cells.jsonl record of each cell, in the grid's order."""
    path = os.path.join(outdir, "cells.jsonl")
    last = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                last[rec["cell"]] = rec
    order = {c.name: i for i, c in enumerate(GRID + EXTRA_CELLS)}
    return sorted(last.values(), key=lambda r: (order.get(r["cell"], len(order)), r["cell"]))


def cell_table(recs, ref):
    """One row a cell from cells.jsonl, porotpu's count beside the port's."""
    lines = ["| cell | dofs | iterations (porotpu) | guard abs / rel | setup s | solve s "
             "| peak MiB | K1 / K2 / plain / ELL | card |", "|" + "---|" * 9]
    for r in recs:
        theirs = (ref.get(r["case"], {}).get((r["N"], "")) or (None,))[0]
        if r["rc"] != 0:
            lines.append(f"| {r['cell']} | — | FAILED (rc {r['rc']}) | | | | | | {r['card']} |")
            continue
        guard = f"{r['guard_abs']:.3e} / {r['guard_rel']:.3e}" + ("" if r["guard_met"]
                                                                  else " NOT met")
        lines.append(
            f"| {r['cell']} | {r['dofs']:,} | {_count(r['iterations'], r['converged'])} "
            f"({'port-only' if theirs is None else theirs}) | {guard} | {r['setup_s']:.2f}"
            f"{' (cache)' if r['restored'] else ''} | {r['solve_s']:.2f} | "
            f"{'—' if r['peak_mib'] is None else format(r['peak_mib'], '.1f')} | "
            f"{r['K1']} / {r['K2']} / {r['plain']} / {r['ell_products']} | "
            f"{r['card'] or r['device']}{', ' + r['power_limit'] if r['power_limit'] else ''} |")
    return lines


def summarize(outdir="output/torch", reference="output"):
    """The markdown of ``--summarize``: with a reference directory, the
    compared grid and the per-cell table; without one, porotpu's table."""
    logs = read_logs(outdir)
    if not reference:
        return "\n".join(plain_table(logs))
    ref = read_logs(reference)
    out = ["# Robustness sweep on the port: outer iterations vs mesh size N", "",
           f"The port's count ({outdir}), then porotpu's ({reference}): `=` equal, `≠` "
           "different, `port-only` porotpu has none; `*` not converged at the solver's "
           "maxiter; a tagged run follows its cell.", ""]
    out += compared_table(logs, ref)
    recs = records(outdir)
    if recs:
        out += ["", "## Cells (cells.jsonl, the last run of each)", ""] + cell_table(recs, ref)
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*", help="cell names or shell patterns (default: the grid)")
    ap.add_argument("--ns", type=int, nargs="+", help="run the chosen cells at these N")
    ap.add_argument("--outdir", default="output/torch", help="where the logs and cells.jsonl go")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cache-dir", default=".cache",
                    help="the cells' solver caches ('' for none)")
    ap.add_argument("--summarize", action="store_true",
                    help="print the table of --outdir's logs against --reference's")
    ap.add_argument("--reference", default="output",
                    help="porotpu's logs ('': print --outdir's table alone)")
    ap.add_argument("--list", action="store_true", help="print the cells' names")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--record", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        cell = json.loads(args.child)
        run_cell(Cell(**cell), args.device, args.cache_dir, args.record)
        return 0
    if args.summarize:
        print(summarize(args.outdir, args.reference))
        return 0
    cells = select(args.cells, args.ns)
    if args.list:
        print("\n".join(c.name for c in cells))
        return 0
    failed = run(cells, args.outdir, args.device, args.cache_dir)
    if failed:
        print(f"[grid] {len(failed)} cell(s) failed: {' '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

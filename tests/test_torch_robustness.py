"""The robustness grid's runner on the port (porotpu_torch/tools/robustness.py).

On the CPU and without any porotpu solve: the runner's cells against the
ones paper-scripts/robustness_2d.sh runs, ``--summarize`` on porotpu's
own logs against output/SUMMARY.md, two cells at N=2 with ``--device
cpu`` (their logs, their cells.jsonl lines, a rerun that skips them), a
cell made to fail, and the marks of the compared table on written logs.
The runner's import rules are checked in the subprocess of
tests/torch_k1_cases.py (test_torch_drivers.py).
"""

import json
import os
import re

import pytest

from porotpu_torch.tools import robustness
from torch_k1_cases import one_blas_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUT = os.path.join(REPO, "output")


def _script_cells():
    """(case, driver, N, options file, pc type) of each run_case line of
    robustness_2d.sh, expanded over its NS_* defaults in its order."""
    with open(os.path.join(REPO, "paper-scripts", "robustness_2d.sh")) as fh:
        text = fh.read()
    defaults = dict(re.findall(r'^(NS_\w+)=\$\{\1:-"([^"]*)"\}$', text, re.M))
    cells, ns, body = [], None, []
    for line in text.splitlines():
        m = re.match(r"\s*for N in \$(NS_\w+); do$", line)
        if m:
            ns, body = [int(n) for n in defaults[m[1]].split()], []
            continue
        m = re.match(r'\s*run_case (\w+)\.py \$N (\S+) "([^"]*)" '
                     r"\$OUTDIR/robustness-2d-(\S+)\.out$", line)
        if m:
            body.append((m[4], m[1], m[2], m[3]))
        elif line.strip() == "done":
            cells += [(case, drv, n, opts, pc) for n in ns for case, drv, opts, pc in body]
    return cells


def test_grid_is_robustness_2d_sh():
    want = _script_cells()
    assert len(want) == 46
    assert [(c.case, c.driver, c.N, c.opts, c.pc) for c in robustness.GRID] == want
    assert [c.header for c in robustness.GRID[:2]] == [
        "swelling.py pc='diagonal' N=10 opts=petsc-options-exact",
        "swelling.py pc='diagonal 3-way' N=10 opts=petsc-options-exact",
    ]
    # fill_robustness_cells.sh's order: smallest N first, the script's within one N
    order = robustness.select()
    assert [c.N for c in order] == sorted(c.N for c in robustness.GRID)
    assert [c.name for c in order if c.N == 10] == [c.name for c in robustness.GRID if c.N == 10]
    # the plan-B cell: its tag in the header, its own name
    extra, = robustness.select(["footing-3way-inexact-80-*"])
    assert extra.header.endswith("opts=petsc-options-inexact [maxiter 800]")
    assert extra.name == "footing-3way-inexact-80-maxiter800"


def test_summarize_porotpu_logs_is_summary_md(capsys):
    assert robustness.main(["--summarize", "--outdir", OUTPUT, "--reference", ""]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("|")]
    with open(os.path.join(OUTPUT, "SUMMARY.md")) as fh:
        want = [ln.rstrip("\n") for ln in fh if ln.startswith("|")]
    assert got == want


# a cell with an override and its tag, as tools/tpu_grid_cells.py's: 20
# iterations stop footing 3-way qexact at N=2 short of the 30 it takes
CAPPED = robustness.Cell("footing-3way-qexact", "footing", 2, "petsc-options-exact-iterative",
                         "undrained 3-way", {"solver maxiter": 20}, "[maxiter 20]", "-maxiter20")


@pytest.fixture(scope="module")
def two_cells(tmp_path_factory):
    """Two cells at N=2 on the CPU, each in its child process: one of the
    grid and one with an override."""
    out = tmp_path_factory.mktemp("grid")
    argv = ["swelling-2way-inexact-10", "*-maxiter20", "--ns", "2", "--device", "cpu",
            "--outdir", str(out / "logs"), "--cache-dir", str(out / "cache")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(robustness, "EXTRA_CELLS", robustness.EXTRA_CELLS + (CAPPED,))
        assert robustness.main(argv) == 0
    return out, argv


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def test_cells_write_logs_and_records(two_cells, capsys):
    out, _ = two_cells
    logs = out / "logs"
    assert robustness.read_logs(logs) == {
        "footing-3way-qexact": {(2, "[maxiter 20]"): (20, False)},
        "swelling-2way-inexact": {(2, ""): (9, True)},
    }
    log = _lines(logs / "robustness-2d-swelling-2way-inexact.out")
    assert log[:2] == ["", "swelling.py pc='diagonal' N=2 opts=petsc-options-inexact"]
    assert any(ln.startswith("-------- Solved time t=0.10. 9 iterations") for ln in log)
    log = _lines(logs / "robustness-2d-footing-3way-qexact.out")
    assert log[1] == ("footing.py pc='undrained 3-way' N=2 opts=petsc-options-exact-iterative "
                      "[maxiter 20]")
    recs = [json.loads(ln) for ln in _lines(logs / "cells.jsonl")]
    assert [(r["cell"], r["iterations"], r["converged"], r["rc"]) for r in recs] == [
        ("swelling-2way-inexact-2", 9, True, 0), ("footing-3way-qexact-2-maxiter20", 20, False, 0)]
    assert recs[0]["guard_met"]
    for r in recs:
        assert r["dofs"] == 109 and r["K1"] == 0 and r["plain"] > 0 and r["card"] is None
        assert r["peak_mib"] is None and r["setup_s"] > 0 and r["solve_s"] > 0
    assert sorted(os.listdir(out / "cache")) == [
        "torch_grid_footing-3way-qexact-2-maxiter20.pkl", "torch_grid_swelling-2way-inexact-2.pkl"]
    robustness.main(["--summarize", "--outdir", str(logs), "--reference", OUTPUT])
    table = capsys.readouterr().out
    assert "| swelling-2way-inexact | 9 port-only | — (9) |" in table
    assert "| footing-3way-qexact | —; 20* [maxiter 20] | — (194) |" in table
    assert "| footing-3way-qexact-2-maxiter20 | 109 | 20* (port-only) |" in table


def test_rerun_skips_cells_done(two_cells, capsys, monkeypatch):
    out, argv = two_cells
    logs = out / "logs"
    monkeypatch.setattr(robustness, "EXTRA_CELLS", robustness.EXTRA_CELLS + (CAPPED,))
    before = {p: _lines(logs / p) for p in os.listdir(logs)}
    assert robustness.main(argv) == 0
    assert {p: _lines(logs / p) for p in os.listdir(logs)} == before
    assert capsys.readouterr().out.count("done, skipped") == 2


def test_failed_cell_is_marked_and_the_run_exits_nonzero(tmp_path, monkeypatch):
    bad = robustness.Cell("swelling-2way-inexact", "swelling", 2, "petsc-options-inexact",
                          "no such pc", label="-bad")
    monkeypatch.setattr(robustness, "EXTRA_CELLS", robustness.EXTRA_CELLS + (bad,))
    assert robustness.main(["*-bad", "--device", "cpu", "--outdir", str(tmp_path),
                            "--cache-dir", ""]) == 1
    log = _lines(tmp_path / "robustness-2d-swelling-2way-inexact.out")
    assert log[1] == "swelling.py pc='no such pc' N=2 opts=petsc-options-inexact"
    assert log[-1] == robustness.FAILED
    rec, = (json.loads(ln) for ln in _lines(tmp_path / "cells.jsonl"))
    assert rec["cell"] == "swelling-2way-inexact-2-bad" and rec["rc"] != 0
    assert robustness.read_logs(tmp_path) == {"swelling-2way-inexact": {(2, ""): (None, False)}}
    assert not robustness.done(bad, tmp_path)  # a failed cell runs again


def test_compared_table_marks(tmp_path):
    """``=``, ``≠``, ``port-only``, not converged, a tagged run, a failure
    and a cell the port has not run, on logs written here."""
    def write(case, text):
        (tmp_path / f"robustness-2d-{case}.out").write_text(text)

    solved = "-------- Solved time t=0.10. {} iterations in 1.00s\n"
    write("swelling-2way-inexact",
          "\nswelling.py pc='diagonal' N=10 opts=petsc-options-inexact\n" + solved.format(9)
          + "\nswelling.py pc='diagonal' N=20 opts=petsc-options-inexact\n" + solved.format(13))
    write("footing-3way-inexact",
          "\nfooting.py pc='undrained 3-way' N=80 opts=petsc-options-inexact\n"
          + solved.format(500) + "---- [Cell] footing-3way-inexact-80: converged=False\n"
          + "\nfooting.py pc='undrained 3-way' N=80 opts=petsc-options-inexact [maxiter 800]\n"
          + solved.format(650) + "---- [Cell] x: converged=True\n")
    write("footing-3way-qexact",
          "\nfooting.py pc='undrained 3-way' N=40 opts=petsc-options-exact-iterative\n"
          + "Traceback\n" + robustness.FAILED + "\n")
    rows = {ln.split(" | ")[0]: ln.split(" | ")[1:] for ln in
            robustness.compared_table(robustness.read_logs(tmp_path),
                                      robustness.read_logs(OUTPUT))[2:]}
    assert rows["| swelling-2way-inexact"][:2] == ["9 = 9", "13 ≠ 12"]
    assert rows["| swelling-2way-inexact"][-1] == "— (17) |"
    assert rows["| footing-3way-inexact"][:4] == ["— (196)", "— (248)", "— (403)",
                                                  "500* port-only; 650 [maxiter 800]"]
    assert rows["| footing-3way-qexact"][:3] == ["— (194)", "—", "FAILED"]



def test_parallel_runs_never_interleave(tmp_path, monkeypatch):
    """Runners started in parallel on cells of one case (as chip runs of
    the grid start several) leave each cell's block whole in the case's
    log.  The children are stand-ins that print their lines slowly."""
    import sys
    import threading

    fake = ("import sys, time\n"
            "for i in range(30):\n"
            "    print(sys.argv[1], i, flush=True)\n"
            "    time.sleep(0.004)\n"
            "open(sys.argv[2], 'w').write('{}')\n")
    monkeypatch.setattr(robustness, "child_command", lambda cell, device, cache_dir, record: [
        sys.executable, "-c", fake, cell.name, record])
    cells = robustness.select(["swelling-2way-inexact-*"])
    threads = [threading.Thread(target=robustness.run, args=([c], str(tmp_path), "cpu", ""))
               for c in cells]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    log = _lines(tmp_path / "robustness-2d-swelling-2way-inexact.out")
    assert len(log) == 32 * len(cells)
    for k in range(len(cells)):
        blank, header, *body = log[32 * k:32 * (k + 1)]
        n = re.search(r"N=(\d+)", header)[1]
        assert blank == "" and body == [f"swelling-2way-inexact-{n} {i}" for i in range(30)]

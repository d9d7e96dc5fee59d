"""Port parity for the reference drivers' path: swelling and footing (2D)
with the options files and at the drivers' defaults, porotpu_torch
against porotpu on the same problem in f64 on the CPU.

Each run solves its time steps on both sides and must give the same outer
iteration count at every step, the last step's residual history to 1e-8
relative (both record it in f32), the final solution to 1e-10 relative
(summation order only) and the true-residual field-wise guard.  The runs:

- swelling N=4, petsc-options-inexact (cg+amg inner solves, LU Schur);
- footing N=3, petsc-options-inexact, pc type undrained (banded
  transposes, cg+amg inner solves);
- swelling N=4, petsc-options-exact (dense LU for the solid and the whole
  fluid-pressure block);
- swelling N=3 at the drivers' defaults over three steps (tf 0.3): the
  full-residual RHS, whose history terms couple the steps, and cg+amg
  inner solves.

The options file's ``-global_ksp_type gmres`` shadows ``--solver-type
aar`` on both sides (swelling N=4 inexact), also under
``--inner-accel-order 1``.

Also: the storage format device_matrix chose for each operator of
footing (N=3 with banded transposes, N=10 with ELL coupling blocks)
against porotpu's, the options files and the CLI parser against
porotpu's, a driver run as a module with jax unimportable, the features
ROADMAP M7.5 and M7.6 ported (the solver cache, export, inner monitors)
at N=2, the inner-monitor lines against porotpu's, the exported solution
fields against porotpu's, and checkpoints crossing between the packages.
"""

import collections
import contextlib
import copy
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from porotpu.models import benchmarks as jbench
from porotpu.utils.options import OptionsDB as JOptionsDB
from porotpu.utils.parser import Parser as JParser
from porotpu_torch.drivers import swelling
from porotpu_torch.models import benchmarks
from porotpu_torch.solvers.convergence import FieldwiseTest
from porotpu_torch.utils.options import OptionsDB
from porotpu_torch.utils.parser import Parser
from torch_k1_cases import import_checks, one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_FILES = ("petsc-options-inexact", "petsc-options-exact", "petsc-options-exact-iterative")

# name -> (benchmark, N, command-line flags, parameter overrides)
RUNS = {
    "swelling_inexact": ("swelling", 4, ["--petsc-options", "petsc-options-inexact"], {}),
    "footing_inexact": (
        "footing", 3,
        ["--petsc-options", "petsc-options-inexact", "--pc-type", "undrained"], {},
    ),
    "swelling_exact": ("swelling", 4, ["--petsc-options", "petsc-options-exact"], {}),
    "swelling_defaults_3_steps": ("swelling", 3, [], {"tf": 0.3}),
}


def _argv(flags):
    """Flags with the options file as a path into the repository."""
    return [os.path.join(REPO, f) if f.startswith("petsc-options") else f for f in flags]


_SOLVED = {}


def _solved(run_name):
    """porotpu's and the port's problem of a run, each solved once per
    module (the footing storage check reuses footing_inexact's)."""
    if run_name not in _SOLVED:
        name, N, flags, overrides = RUNS[run_name]
        jp = getattr(jbench, name)(N, parser=JParser(_argv(flags)), overrides=overrides)
        jp.solve()
        p = getattr(benchmarks, name)(
            N, parser=Parser(_argv(flags)), overrides=overrides, device="cpu"
        )
        p.solve()
        _SOLVED[run_name] = jp, p
    return _SOLVED[run_name]


@pytest.fixture(scope="module", params=list(RUNS))
def run(request):
    return (request.param, *_solved(request.param))


def test_run_matches_porotpu(run):
    name, jp, p = run
    assert p.dtype == torch.float64
    assert p.iteration_log == jp.iteration_log, name
    assert len(p.iteration_log) == (3 if name.endswith("3_steps") else 1)
    jr, r = jp.last_result, p.last_result
    assert r.converged and bool(jr.converged)
    jh = np.asarray(jr.history)
    assert np.array_equal(np.isnan(r.history), np.isnan(jh))
    live = ~np.isnan(jh)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=1e-8, atol=0)
    x, jx = p.sol.numpy(), np.asarray(jp.sol)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()


def test_run_true_residual_guard(run):
    name, _, p = run
    b = p.last_rhs
    with torch.inference_mode():
        r = b - p.A_dev.matvec(p.sol)
        ea, er = FieldwiseTest.from_sizes(p.padded_sizes, b).errors(r)
    atol = float(p.parameters["solver atol"])
    rtol = float(p.parameters["solver rtol"])
    assert float(ea) < atol or float(er) < rtol, (name, float(ea), float(er))


def test_full_residual_history_reaches_the_rhs(run):
    """At the defaults the RHS of a later step carries the history terms
    through the device operators H_dev; with the options files the
    drivers also run full-residual (porotpu's default rhs mode)."""
    name, jp, p = run
    assert p.assembler.rhs_mode == "full-residual" and p.H_dev is not None
    assert sorted(p.H_dev.keys()) == sorted(jp.H_dev.keys())
    b_loads = np.zeros(p.n_pad)
    b_loads[p.pad_index] = p.assembler.get_load_vector(p.t)
    b = p.get_rhs(p.t).numpy()
    free = np.ones(p.n_pad, bool)
    free[p.bc_dofs.numpy()] = False
    assert np.abs(b - b_loads)[free].max() > 0
    jb = np.asarray(jp.get_rhs(jp.t))
    assert np.abs(b - jb).max() <= 1e-12 * np.abs(jb).max()


@pytest.mark.parametrize(
    "flags", [["--solver-type", "aar"], ["--solver-type", "aar", "--inner-accel-order", "1"]],
    ids=["aar", "aar_accel1"],
)
def test_options_file_shadows_solver_type(flags, capfd):
    """petsc-options-inexact sets -global_ksp_type gmres, which overrides
    ``solver type`` (porotpu/models/poromechanics.py:790-795): with
    ``--solver-type aar`` porotpu and the port both run FGMRES, the
    swelling_inexact run exactly.  With ``--inner-accel-order 1`` too the
    port's Anderson-mixed PC output only adds stored directions, so the
    FGMRES trace and solution are porotpu's without it (:845-856)."""
    jp0, p0 = _solved("swelling_inexact")
    argv = _argv(["-N", "4", "--petsc-options", "petsc-options-inexact", "--monitor"] + flags)
    capfd.readouterr()
    p = swelling.setup(argv + ["--device", "cpu"])
    p.solve()
    if "--inner-accel-order" not in flags:
        # porotpu resolves the solver type its jitted solve closes over to
        # gmres: it runs swelling_inexact's FGMRES, whose trace jp0 holds
        jp = jbench.swelling(4, parser=JParser(argv))
        jp.create_solver()
        fn = jp._solve_fn
        closed = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
        assert closed["solver_type"] == "gmres"
        np.testing.assert_array_equal(p.sol.numpy(), p0.sol.numpy())
    assert "[AAR]" not in capfd.readouterr().out
    assert p.iteration_log == jp0.iteration_log
    jh = np.asarray(jp0.last_result.history)
    live = ~np.isnan(jh)
    np.testing.assert_allclose(p.last_result.history[live], jh[live], rtol=1e-6, atol=0)
    jx = np.asarray(jp0.sol)
    assert np.abs(p.sol.numpy() - jx).max() <= 1e-10 * np.abs(jx).max()


OPERATORS = ("DIA", "ELL", "Dense", "Transposed")


def _format(op):
    """(rows, cols, format) of a device operator, on either side; a
    Transposed block is "T" and its inner's format."""
    name = type(op).__name__
    if name == "Transposed":
        rows, cols, fmt = _format(op.inner)
        return cols, rows, "T" + fmt
    if name == "ELL":
        return int(op.data.shape[0]), int(op.ncols), name
    if name == "Dense":
        return (*map(int, op.data.shape), name)
    return int(op.nrows), int(op.ncols), name


def _pc_formats(obj, acc, seen, port):
    """Count the formats of the operators in a PC tree: the port's modules,
    or porotpu's objects, dicts and sequences."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if type(obj).__name__ in OPERATORS:
        acc[_format(obj)] += 1
        return
    if port:
        leaves = list(obj.children())
    elif isinstance(obj, dict):
        leaves = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        leaves = list(obj)
    elif type(obj).__module__.startswith("porotpu."):
        leaves = list(vars(obj).values())
    else:
        return
    for leaf in leaves:
        _pc_formats(leaf, acc, seen, port)
    return acc


@pytest.mark.parametrize("N", [3, 10])
def test_footing_storage_formats_match_porotpu(N):
    """device_matrix picks the same format (DIA, ELL, Dense, Transposed)
    for every block of the outer operator, every history operator and
    every operator of the PC as porotpu's: at N=3 the coupling blocks and
    prolongators are banded transposes (K2 on the card), at N=10 (the
    smallest N whose formats count as N=12's) the coupling blocks store
    ELL and one level Dense."""
    flags = ["--petsc-options", "petsc-options-inexact", "--pc-type", "undrained"]
    if (N, flags) == RUNS["footing_inexact"][1:3]:
        jp, p = _solved("footing_inexact")
    else:
        jp = jbench.footing(N, parser=JParser(_argv(flags)))
        jp._build_operators()
        p = benchmarks.footing(N, parser=Parser(_argv(flags)), device="cpu")
        p._build_operators()
    blocks = {r + c: _format(op) for (r, c), op in jp.A_dev.blocks.items()}
    assert {k: _format(op) for k, op in p.A_dev.blocks.items()} == blocks
    assert {k: _format(op) for k, op in p.H_dev.items()} == {
        k: _format(op) for k, op in jp.H_dev.items()
    }
    pc = _pc_formats(p.pc, collections.Counter(), set(), port=True)
    assert pc == _pc_formats(jp.pc, collections.Counter(), set(), port=False)
    fmts = {f for _, _, f in blocks.values()} | {f for _, _, f in pc}
    assert ("TDIA" in fmts) if N == 3 else ({"ELL", "Dense"} <= fmts)


@pytest.mark.parametrize("fname", OPTION_FILES)
def test_options_files_give_porotpus_inner_configs(fname):
    path = os.path.join(REPO, fname)
    db, jdb = OptionsDB.from_file(path), JOptionsDB.from_file(path)
    assert db.entries == jdb.entries
    prefixes = {k.split("_")[0] for k in db.entries} | {"fp_fieldsplit_0", "fp_fieldsplit_1"}
    assert {"global", "s", "f", "p", "diff", "fp"} <= prefixes
    for prefix in sorted(prefixes):
        assert db.prefix_items(prefix) == jdb.prefix_items(prefix), prefix
        cfg, jcfg = db.inner_config(prefix), jdb.inner_config(prefix)
        assert (cfg is None) == (jcfg is None), prefix
        if cfg is not None:
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), prefix


def test_parser_gives_porotpus_options_dict():
    flags = [
        "-N", "7", "--N-refinements", "1", "--pc-type", "undrained", "--time-final", "0.3",
        "--dtype", "float32", "--monitor", "--solver-chunk", "50",
        "--petsc-options", os.path.join(REPO, "petsc-options-inexact"),
    ]
    got, want = Parser(flags).options_dict, JParser(flags).options_dict
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].entries == v.entries) if k == "options db" else got[k] == v, k
    assert Parser(flags).options.device == "cuda"
    cpu = Parser(flags + ["--device", "cpu"])
    assert cpu.options.device == "cpu" and sorted(cpu.options_dict) == sorted(want)


def test_driver_module_runs_without_jax():
    """The swelling driver run as a module with jax unimportable, in the
    subprocess the slice's import checks share (tests/torch_k1_cases.py)."""
    got = import_checks()["driver"]
    assert got["foreign"] == ["jax"], got["foreign"]
    assert "Solved time t=0.10." in got["stdout"] and "Timing Solver" in got["stdout"]


def test_robustness_runner_runs_without_jax():
    """One cell of the robustness runner (swelling 2-way exact at N=2, the
    code its child process runs) with jax unimportable, in the same
    subprocess: the 8 iterations the exact options take at N=2, on the
    plain versions."""
    got = import_checks()["robustness"]
    assert got["foreign"] == ["jax"], got["foreign"]
    assert got["iterations"] == 8 and got["plain"] > 0, got


def _swelling_2d(**overrides):
    return benchmarks.swelling(2, overrides=overrides, device="cpu")


# a monitor line as porotpu prints it: its label and |r| to 5 digits
MONITOR = re.compile(r"^  \[inner (\w+)\] \|r\|=\d\.\d{4}e[+-]\d\d$", re.M)


@pytest.mark.parametrize("what", ["outer_cg", "cache", "export", "inner_monitor"])
def test_other_unported_features_raise(what, tmp_path, monkeypatch, capfd):
    """The features whose raises these cases checked are ported (ROADMAP
    M7.5, M7.6); each case runs its feature at swelling N=2.  outer_cg:
    ``--inner-monitor`` through the swelling driver's parser prints one
    line for each inner solve of each PC apply (s, fp_f, fp_S); cache:
    ``solver cache path`` saves the solver, and a fresh problem restores it
    and takes the same iterations to the same solution; export: ``output
    solutions`` writes porotpu's XDMF time series (t0 and each step) into
    output/; inner_monitor: the parameter prints the lines."""
    capfd.readouterr()
    if what == "cache":
        path = str(tmp_path / "swelling.pkl")
        p = _swelling_2d(**{"solver cache path": path})
        p.solve()
        p.cache_writer.join(timeout=60)
        q = _swelling_2d()
        assert q.try_load_solver_cache(path)
        q.solve()
        assert q.iteration_log == p.iteration_log and torch.equal(q.sol, p.sol)
        return
    if what == "export":
        import h5py

        monkeypatch.chdir(tmp_path)
        p = _swelling_2d(**{"output solutions": True, "tf": 0.2})
        p.solve()
        p._exporter.close()
        assert sorted(os.listdir("output")) == ["swelling.h5", "swelling.xdmf"]
        with h5py.File("output/swelling.h5") as f:
            assert sorted(f) == ["mesh", "step_000000", "step_000001", "step_000002"]
            u = f["step_000002/displacement"][...]
        np.testing.assert_array_equal(u, p.solution_fields()["displacement"])
        return
    if what == "outer_cg":
        p = swelling.setup(["-N", "2", "--inner-monitor", "--device", "cpu"])
        assert p.parameters["inner monitor"] is True
    else:
        p = _swelling_2d(**{"inner monitor": True})
    p.solve()
    labels = MONITOR.findall(capfd.readouterr().out)
    assert labels == ["s", "fp_f", "fp_S"] * p.iteration_log[0], labels


# swelling N=2 with cg + Jacobi x 3 inner solves: every inner residual stays
# far above rounding, so the two packages' values can be compared
MONITORED = {"inner monitor": True, "inner ksp type": "cg", "inner pc type": "jacobi",
             "inner iters": 3}


def test_inner_monitor_lines_match_porotpu(monkeypatch, capfd):
    """The port's inner-monitor lines against porotpu's (its
    ``jax.debug.print``, which keeps the order of the applies here): the
    same labels in the same order, and |r| within 1e-8 relative, both
    printed to 17 digits for the comparison."""
    import jax

    from porotpu_torch.precond import inner

    real = jax.debug.print
    monkeypatch.setattr(jax.debug, "print",
                        lambda fmt, **kw: real(fmt.replace(":.4e}", ":.17e}"), **kw))
    monkeypatch.setattr(inner, "MONITOR_LINE", inner.MONITOR_LINE.replace(":.4e}", ":.17e}"))
    line = re.compile(r"^  \[inner (\w+)\] \|r\|=(\S+)$", re.M)
    capfd.readouterr()
    jp = jbench.swelling(2, overrides=dict(MONITORED))
    jp.solve()
    jax.effects_barrier()
    want = line.findall(capfd.readouterr().out)
    p = benchmarks.swelling(2, overrides=dict(MONITORED), device="cpu")
    p.solve()
    got = line.findall(capfd.readouterr().out)
    assert p.iteration_log == jp.iteration_log
    assert [lab for lab, _ in got] == [lab for lab, _ in want]
    assert [lab for lab, _ in want] == ["s", "fp_f", "fp_S"] * jp.iteration_log[0]
    np.testing.assert_allclose([float(v) for _, v in got], [float(v) for _, v in want],
                               rtol=1e-8, atol=0)


def test_solution_fields_match_porotpu():
    """The exported vertex values (``vert_node`` of each space) of the last
    step of swelling_defaults_3_steps, to 1e-10 of each field's largest."""
    jp, p = _solved("swelling_defaults_3_steps")
    got, want = p.solution_fields(), jp.solution_fields()
    assert list(got) == list(want) == ["displacement", "fluid velocity", "pressure"]
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape == ((p.mesh.num_vertices, 2) if k != "pressure"
                                           else (p.mesh.num_vertices,)), k
        assert np.abs(got[k] - w).max() <= 1e-10 * np.abs(w).max(), k


# the time-stepping state a step changes, put back after a test that steps
# a shared run further
STEP_STATE = ("t", "us_nm1", "us_nm2", "uf_nm1", "p_nm1", "sol", "last_result", "last_rhs",
              "iteration_log", "pc_applies", "t_solve_total")


@contextlib.contextmanager
def _stepped_back(*problems):
    saved = [{k: copy.copy(getattr(q, k)) for k in STEP_STATE if hasattr(q, k)}
             for q in problems]
    try:
        yield
    finally:
        for q, state in zip(problems, saved):
            for k, v in state.items():
                setattr(q, k, v)


def test_checkpoints_cross_between_packages(tmp_path):
    """After swelling_defaults_3_steps' three steps, porotpu's checkpoint
    resumes the port's problem and the port's resumes porotpu's for a
    fourth step (its full-residual RHS reads every history field): the same
    count on both sides, and on each side the count and x of continuing its
    own state, x within 1e-10 relative.  Both problems are put back."""
    from porotpu.utils import io as jio
    from porotpu_torch.utils import io

    jp, p = _solved("swelling_defaults_3_steps")
    jpath, path = str(tmp_path / "porotpu.npz"), str(tmp_path / "port.npz")
    jio.save_checkpoint(jpath, jp, jp.t)
    io.save_checkpoint(path, p, p.t)
    with _stepped_back(jp, p):
        its_own, jits_own = p.solve_time_step(p.t + p.dt), jp.solve_time_step(jp.t + jp.dt)
        x_own, jx_own = p.sol.numpy(), np.asarray(jp.sol)
    with _stepped_back(jp, p):
        t, jt = io.load_checkpoint(jpath, p), jio.load_checkpoint(path, jp)
        assert t == jt == p.t == jp.t and p.us_nm2.dtype == torch.float64
        its, jits = p.solve_time_step(t + p.dt), jp.solve_time_step(jt + jp.dt)
        x, jx = p.sol.numpy(), np.asarray(jp.sol)
    assert its == jits == its_own == jits_own
    for a, b in ((x, jx), (x, x_own), (jx, jx_own), (x_own, jx_own)):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    assert p.iteration_log == jp.iteration_log and len(p.iteration_log) == 3

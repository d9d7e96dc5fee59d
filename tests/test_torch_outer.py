"""Port parity for ROADMAP M7.3 and M7.4: the outer solvers porotpu's
``solvers/`` has beyond FGMRES, and the solid and fluid-pressure
subsystems, porotpu_torch against porotpu on the same numpy inputs made
from a seed, f64 on the CPU.

- ``cg``: the 2-norm and the field-wise stop, ``divtol`` and a p.Ap of
  zero: the same iterations, the f32 history to 1e-6 relative, x to 1e-10.
- ``gmres`` (no Z, x = x0 + M(V y)) with and without ``pc_accel_order`` on
  the inputs of porotpu's ``test_gmres_pc_accel_order``, and ``fgmres``
  with ``pc_accel_order`` 1 and 2: iterations, history and x.
- ``gram_ls_alpha`` to 1e-12, and ``AndersonAccelerator.step`` over a
  linear fixed point with a stagnating pair in it: every output, the
  history count and the final rings.
- ``aar`` at orders 0 and 10 with a p that mixes and a p that does not,
  and ``pc_accel_order`` 1 (order 0 over a whole run; order 10 over its
  first three iterations, after which the Gram matrix of the mixed history
  is singular to rounding on both sides); ``monitor``'s [R]/[A] lines
  equal porotpu's.
- ``preonly``, ``richardson`` and ``estimate_spectrum``.
- The model at swelling N=3 through the port's driver ``setup`` against
  porotpu's: ``--solver-type aar`` (its [R]/[A] steps) and
  ``--solver-type cg`` under ``solver maxiter`` 20; ``solver chunk`` for
  cg and aar as porotpu decides it.  (``--inner-accel-order 1`` and the
  options file that shadows aar: tests/test_torch_drivers.py.)
- ``solid_problem`` and ``fluid_pressure_problem`` at N=2: CSR and RHS;
  the ``solid`` and ``fluid_pressure`` drivers at N=3 in f64: the count
  and x.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import porotpu.solvers as J
from porotpu.models import benchmarks as jbench
from porotpu.models import subsystems as jsub
from porotpu.solvers.anderson import gram_ls_alpha as j_gram_ls_alpha
from porotpu.solvers.convergence import FieldwiseTest as JFieldwiseTest
from porotpu.utils.parser import Parser as JParser
from porotpu_torch import solvers as T
from porotpu_torch.drivers import fluid_pressure, solid, swelling
from porotpu_torch.models import subsystems
from porotpu_torch.solvers.anderson import gram_ls_alpha
from porotpu_torch.solvers.convergence import FieldwiseTest
from torch_k1_cases import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _system(n=120, seed=25, spd=False):
    """A sparse test matrix (porotpu's tests/test_ops_solvers.py:_random_csr),
    a seeded right-hand side and the Jacobi preconditioner, on both sides."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    A = (A @ A.T if spd else A) + n * sp.eye(n)
    b = np.random.default_rng(seed + 1).normal(size=n)
    return _sides(A.toarray(), b, 1.0 / A.diagonal())


def _sides(Ad, b, dinv):
    jA, tA = jnp.asarray(Ad), torch.as_tensor(Ad)
    jd, td = jnp.asarray(dinv), torch.as_tensor(dinv)
    return (
        (lambda x: jA @ x, jnp.asarray(b), lambda r: jd * r),
        (lambda x: tA @ x, torch.as_tensor(b), lambda r: td * r),
    )


def _assert_result(jr, r, hist_rtol=1e-6, x_rtol=1e-10):
    assert r.iters == int(jr.iters)
    assert r.converged == bool(jr.converged) and r.diverged == bool(jr.diverged)
    jh = np.asarray(jr.history)
    assert np.array_equal(np.isnan(r.history), np.isnan(jh))
    live = ~np.isnan(jh)
    np.testing.assert_allclose(r.history[live], jh[live], rtol=hist_rtol, atol=0)
    jx = np.asarray(jr.x)
    assert np.abs(r.x.numpy() - jx).max() <= x_rtol * np.abs(jx).max()


@pytest.mark.parametrize("case", ["norm", "fieldwise", "divtol", "zero_pAp"])
def test_cg_matches_porotpu(case):
    (jA, jb, jM), (tA, tb, tM) = _system(spd=True)
    kw = dict(rtol=1e-10, atol=0.0, maxiter=60)
    if case == "fieldwise":
        kw.update(atol=1e-9, rtol=1e-8)
        jkw = dict(kw, fieldwise=JFieldwiseTest.from_sizes((50, 40, 30), jb))
        kw["fieldwise"] = FieldwiseTest.from_sizes((50, 40, 30), tb)
    elif case == "divtol":
        kw["divtol"] = 1.0  # ||b|| is about 11: diverged before the first step
        jkw = kw
    elif case == "zero_pAp":
        # diag(1, -1, ...) and b = 1: p.Ap is exactly 0 on every step
        d = np.where(np.arange(40) % 2 == 0, 1.0, -1.0)
        (jA, jb, jM), (tA, tb, tM) = _sides(np.diag(d), np.ones(40), np.ones(40))
        kw["maxiter"] = 5
        jkw = kw
    else:
        jkw = kw
    jr = J.cg(jA, jb, M=jM, **jkw)
    r = T.cg(tA, tb, M=tM, **kw)
    _assert_result(jr, r)
    assert r.converged == (case in ("norm", "fieldwise"))
    assert r.diverged == (case == "divtol")


@pytest.mark.parametrize(
    "solver,accel", [("gmres", 0), ("gmres", 2), ("fgmres", 1), ("fgmres", 2)]
)
def test_gmres_matches_porotpu(solver, accel):
    """Restarted at 30 so that the accelerator state crosses restarts."""
    (jA, jb, jM), (tA, tb, tM) = _system()
    kw = dict(rtol=1e-10, maxiter=200, restart=30, pc_accel_order=accel)
    jr = getattr(J, solver)(jA, jb, M=jM, **kw)
    r = getattr(T, solver)(tA, tb, M=tM, **kw)
    _assert_result(jr, r)


@pytest.mark.parametrize("nhist", [0, 2, 6])
def test_gram_ls_alpha_matches_porotpu(nhist):
    rng = np.random.default_rng(nhist)
    F, f = rng.normal(size=(6, 50)), rng.normal(size=50)
    want = np.asarray(j_gram_ls_alpha(jnp.asarray(F), jnp.asarray(f), nhist, 1e-3))
    got = gram_ls_alpha(torch.as_tensor(F), torch.as_tensor(f), nhist, 1e-3).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(initial=1.0)
    assert (got[: 6 - nhist] == 0).all()


def test_anderson_step_matches_porotpu():
    """x = G x + c with spectral radius 0.95 (porotpu's
    test_anderson_accelerates_linear_fixed_point), order 4; on step 6 the
    input repeats x + f, so ||df|| is rounding and the pair is not pushed."""
    rng = np.random.default_rng(5)
    n = 50
    G = rng.normal(size=(n, n))
    G = 0.5 * (G + G.T)
    G = 0.95 * G / np.max(np.abs(np.linalg.eigvals(G)))
    c = rng.normal(size=n)
    ja, ta = J.AndersonAccelerator(4), T.AndersonAccelerator(4)
    jstep = jax.jit(ja.step)  # one compile, not one dispatch per operation
    js, ts = ja.init(n, dtype=jnp.float64), ta.init(n, torch.float64)
    jx, tx = jnp.zeros(n), torch.zeros(n, dtype=torch.float64)
    nhist = []
    for k in range(12):
        if k == 6:
            jg, tg = js.xk + js.fk, ts.xk + ts.fk
        else:
            jg, tg = jnp.asarray(G) @ jx + jnp.asarray(c), torch.as_tensor(G) @ tx + \
                torch.as_tensor(c)
        js, jx = jstep(js, jg)
        ts, tx = ta.step(ts, tg)
        assert ts.nhist == int(js.nhist) and ts.k == int(js.k) == k + 1
        assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 1e-10 * np.abs(np.asarray(jx)).max()
        nhist.append(ts.nhist)
    assert nhist == [0, 1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4]
    assert nhist[6] == nhist[5]  # the stagnating pair was not pushed ...
    assert np.abs(ts.F.numpy()).max() > 0  # ... and the rings hold porotpu's pairs
    for ring, jring in ((ts.X, js.X), (ts.F, js.F)):
        np.testing.assert_allclose(ring.numpy(), np.asarray(jring), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(jring)).max())


AAR_CASES = {
    # order, p, omega, pc_accel_order, maxiter
    "order0": (0, 5, 0.5, 0, 3000),
    "order10_p5": (10, 5, 0.5, 0, 2000),
    "accel1_order0": (0, 5, 0.5, 1, 2000),
    "accel1_order10_3_its": (10, 2, 0.5, 1, 3),
}


@pytest.mark.parametrize("case", list(AAR_CASES))
def test_aar_matches_porotpu(case, capfd):
    """Also the monitor's [R]/[A] line of every iteration, as porotpu
    prints it (porotpu/solvers/aar.py:117-130)."""
    order, p, omega, accel, maxiter = AAR_CASES[case]
    (jA, jb, jM), (tA, tb, tM) = _system(80, seed=6, spd=True)
    kw = dict(order=order, p=p, omega=omega, beta=1.0, rtol=1e-10, atol=1e-12,
              maxiter=maxiter, pc_accel_order=accel, monitor=True)
    jr = J.aar(jA, jb, M=jM, **kw)
    jr.x.block_until_ready()
    want = _aar_only(capfd.readouterr().out)
    r = T.aar(tA, tb, M=tM, **kw)
    got = _aar_only(capfd.readouterr().out)
    _assert_result(jr, r)
    assert r.converged == (maxiter > 3)
    steps, jsteps = _aar_lines(got), _aar_lines(want)
    assert len(steps) == r.iters and [s[:2] for s in steps] == [s[:2] for s in jsteps]
    np.testing.assert_allclose([s[2] for s in steps], [s[2] for s in jsteps], rtol=1e-6)
    assert {s[1] for s in steps} == ({"A", "R"} if order > 0 else {"R"})


def _aar_only(text):
    return [ln for ln in text.splitlines() if "[AAR]" in ln]


def _aar_lines(lines):
    """(iteration, step type, residual) of each line in porotpu's format."""
    pat = re.compile(r"---- \[AAR\] it (\d+)  \[([AR])\] res = (\d\.\d{6}e[+-]\d\d)$")
    out = [pat.fullmatch(ln) for ln in lines]
    assert all(out), lines
    return [(int(m[1]), m[2], float(m[3])) for m in out]


def test_basic_solvers_and_spectrum_match_porotpu():
    (jA, jb, jM), (tA, tb, tM) = _system(spd=True)
    np.testing.assert_array_equal(T.preonly(tA, tb, tM).numpy(), np.asarray(J.preonly(jA, jb, jM)))
    want = np.asarray(J.richardson(jA, jb, M=jM, omega=0.8, iters=12))
    got = T.richardson(tA, tb, M=tM, omega=0.8, iters=12).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # a spectral gap of 10: both start vectors converge to lambda_max = 10
    (jA, _, _), (tA, _, _) = _sides(np.diag(np.r_[10.0, np.linspace(0.1, 1.0, 59)]),
                                    np.ones(60), np.ones(60))
    want = J.estimate_spectrum(jA, 60, iters=30, dtype=jnp.float64)
    got = T.estimate_spectrum(tA, 60, iters=30, dtype=torch.float64, device="cpu")
    assert abs(got - 10.0) <= 1e-12 * 10 and abs(got - want) <= 1e-12 * 10
    if not torch.cuda.is_available():  # the card by default, as every entry point
        with pytest.raises(RuntimeError, match="no CUDA card"):
            T.estimate_spectrum(tA, 60, iters=30, dtype=torch.float64)


# -- the model --------------------------------------------------------------

MODEL_RUNS = {
    "aar": (["--solver-type", "aar"], {}),
    "cg_maxiter20": (["--solver-type", "cg"], {"solver maxiter": 20}),
}


def _argv(flags):
    return [os.path.join(REPO, f) if f.startswith("petsc-options") else f for f in flags]


@pytest.mark.parametrize("run", list(MODEL_RUNS))
def test_model_solver_types_match_porotpu(run, capfd):
    flags, overrides = MODEL_RUNS[run]
    argv = _argv(["-N", "3", "--monitor"] + flags)
    jp = jbench.swelling(3, parser=JParser(argv), overrides=overrides)
    jp.solve()
    jout = capfd.readouterr().out
    p = swelling.setup(argv + ["--device", "cpu"])
    p.parameters.update(overrides)
    p.solve()
    out = capfd.readouterr().out
    steps, jsteps = _aar_lines(_aar_only(out)), _aar_lines(_aar_only(jout))
    assert [s[:2] for s in steps] == [s[:2] for s in jsteps]
    assert bool(steps) == (run == "aar")
    assert p.iteration_log == jp.iteration_log
    _assert_result(jp.last_result, p.last_result)
    assert p.last_result.converged == (run != "cg_maxiter20")


def test_unknown_solver_type_raises():
    p = swelling.setup(["-N", "2", "--solver-type", "bicg", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown solver type 'bicg'"):
        p._finalize_solver()


@pytest.mark.parametrize("solver_type,chunks", [("cg", 4), ("aar", 1)])
def test_chunk_for_cg_and_aar_matches_porotpu(solver_type, chunks):
    """porotpu chunks cg as warm restarts, with no restart-multiple rule,
    and never chunks aar (porotpu/models/poromechanics.py:785)."""
    over = {"solver type": solver_type, "solver chunk": 7, "solver maxiter": 25}
    jp = jbench.swelling(2, overrides=over)
    jp.H_dev = None
    jp._finalize_solver()
    p = swelling.setup(["-N", "2", "--device", "cpu"])
    p.parameters.update(over)
    p._finalize_solver()
    assert p._solve_chunks == jp._solve_chunks == chunks
    assert p._maxiter == (7 if chunks > 1 else 25)


# -- the subsystems -----------------------------------------------------------

@pytest.mark.parametrize("name", ["solid", "fluid_pressure"])
def test_subsystem_problems_match_porotpu(name):
    A, b, *_ = getattr(subsystems, f"{name}_problem")(2)
    jA, jb, *_ = getattr(jsub, f"{name}_problem")(2)
    if name == "fluid_pressure":
        assert sorted(A) == sorted(jA)
        A = sp.bmat([[A["f", "f"], A["f", "p"]], [A["p", "f"], A["p", "p"]]], format="csr")
        jA = sp.bmat([[jA["f", "f"], jA["f", "p"]], [jA["p", "f"], jA["p", "p"]]], format="csr")
        assert np.abs(b[A.shape[0] - 27:]).max() == 0  # the pressure RHS, r_p = 0
    assert A.shape == jA.shape and (A != jA).nnz == 0
    np.testing.assert_array_equal(b, jb)


def _porotpu_subsystem(name, N):
    """porotpu's solid.py / fluid-pressure.py main at N in f64, the solve
    jitted with the operators as arguments as there: (iterations, x)."""
    from porotpu.fem.dofmap import vertex_embedding
    from porotpu.ops import FieldMatrix, device_matrix
    from porotpu.precond.amg import rigid_body_modes
    from porotpu.precond.inner import InnerConfig, build_inner_solver
    from porotpu.precond.schur import build_schur_fieldsplit

    if name == "solid":
        A, b, V, _ = jsub.solid_problem(N)
        M = build_inner_solver(A, InnerConfig(method="amg"), dofs_per_node=3,
                               near_nullspace=rigid_body_modes(V.node_coords),
                               coords=V.node_coords, dtype=jnp.float64)
        solve = jax.jit(
            lambda Eop, Mop, bb: J.cg(Eop.matvec, bb, M=Mop, rtol=1e-8, atol=0.0, maxiter=500)
        )
        res = solve(device_matrix(A, jnp.float64), M, jnp.asarray(b))
        return int(res.iters), np.asarray(res.x)
    blocks, b, W, _ = jsub.fluid_pressure_problem(N)
    Vf, Qp = W.space("f"), W.space("p")
    emb = vertex_embedding(Qp, Vf)
    M = build_schur_fieldsplit(
        blocks["f", "f"], blocks["f", "p"], blocks["p", "f"], blocks["p", "p"],
        InnerConfig(method="cg+amg", iters=10), InnerConfig(method="lu"), dofs_per_node_f=3,
        coords_f=Vf.node_coords, coords_p=Qp.node_coords, row_emb_pf=emb, dtype=jnp.float64,
    )
    embs = {("f", "p"): dict(col_emb=emb), ("p", "f"): dict(row_emb=emb)}
    E = FieldMatrix(
        {k: device_matrix(v.tocsr(), jnp.float64, **embs.get(k, {}))
         for k, v in blocks.items() if v.nnz},
        {"f": Vf.num_dofs, "p": Qp.num_dofs},
    )
    solve = jax.jit(
        lambda Eop, Mop, bb: J.fgmres(Eop.matvec, bb, M=Mop, rtol=1e-8, atol=0.0, maxiter=300)
    )
    res = solve(E, M, jnp.asarray(b))
    return int(res.iters), np.asarray(res.x)


@pytest.mark.parametrize("name", ["solid", "fluid_pressure"])
def test_subsystem_drivers_match_porotpu(name, capfd):
    its, jx = _porotpu_subsystem(name, 3)
    drv = {"solid": solid, "fluid_pressure": fluid_pressure}[name]
    run = drv.main(["-N", "3", "--dtype", "float64", "--device", "cpu"])
    out = capfd.readouterr().out
    assert run.dtype == torch.float64 and run.result.converged
    assert run.result.iters == its
    assert f"Solved in {its} iterations" in out and "Final residual" in out
    assert f"Dofs = {jx.size}" in out and "Assembled in" in out
    assert np.abs(run.result.x.numpy() - jx).max() <= 1e-10 * np.abs(jx).max()
    assert run.residual <= 1e-8 * np.linalg.norm(run.b)


def test_subsystem_driver_default_dtype_is_f32():
    run = solid.setup(["-N", "2", "--device", "cpu"])
    assert run.dtype == torch.float32 and run.E.matvec(torch.ones(run.b.size)).dtype == \
        torch.float32

"""Benchmark problem configurations on PyTorch (porotpu/models/benchmarks.py).

Ported: swelling-3d, the scaling target and the bench path.
"""

from __future__ import annotations

import numpy as np

from ..fem.bcs import DirichletBC
from ..fem.mesh import generate_boundary_measure, generate_cube
from .loads import NormalLoad, ZeroLoad
from .poromechanics import Poromechanics


def _base_parameters():
    """Common solver defaults of the 3-field benchmark scripts
    (porotpu/models/benchmarks.py:25-57)."""
    return {
        "dt": 0.1,
        "t0": 0.0,
        "tf": 0.1,
        "fe degree solid": 2,
        "fe degree fluid": 2,
        "fe degree pressure": 1,
        "maxiter": 1000,
        "output solutions": False,
        "betas": -0.5,
        "betaf": 0.0,
        "betap": 1.0,
        "solver rtol": 1e-6,
        "solver atol": 1e-4,
        "solver maxiter": 500,
        "solver monitor": False,
        "solver type": "gmres",
        "pc type": "undrained",
        "inner ksp type": "gmres",
        "inner pc type": "hypre",
        "inner atol": 0,
        "inner rtol": 1e-6,
        "inner maxiter": 1000,
        "inner monitor": False,
        "inner accel order": 0,
        "AAR order": 10,
        "AAR p": 5,
        "AAR omega": 1,
        "AAR beta": 1,
    }


def swelling_3d(
    Nelements=10, refinements=0, parser=None, overrides=None, dtype=None, device="cuda"
):
    """3D swelling (reference swelling-3d.py): ks=1e8, maxiter 100, roller
    BCs per face (porotpu/models/benchmarks.py:187-244)."""
    side = 1e-2
    mesh, markers, XP, XM, YP, YM, ZP, ZM = generate_cube(Nelements, side, refinements)
    dsNs = generate_boundary_measure(mesh, markers, [XP, YP, ZP])
    dsNf = generate_boundary_measure(mesh, markers, [XM, YM])

    ramp = lambda t: 1.0 - np.exp(-(t**2) / 0.25)  # noqa: E731
    params = _base_parameters()
    params.update(
        {
            "mu_f": 0.035,
            "rhof": 1e3,
            "rhos": 1e3,
            "phi0": 0.1,
            "mu_s": 4000,
            "lmbda": 700,
            "ks": 1e8,
            "kf": 1e-7,
            "output name": "swelling-3d",
            "solver atol": 1e-8,
            "solver rtol": 1e-6,
            "solver maxiter": 100,
            "inner maxiter": 100,
            "pc type": "diagonal",
            "dsNs": dsNs,
            "dsNf": dsNf,
            "ff_vol": ZeroLoad(3),
            "fs_vol": ZeroLoad(3),
            "ff_sur": NormalLoad(lambda t: -1e3 * 0.1 * ramp(t)),
            "fs_sur": NormalLoad(lambda t: -1e3 * 0.9 * ramp(t)),
            "p_source": ZeroLoad(),
        }
    )
    if overrides:
        params.update(overrides)

    kwargs = {"dtype": dtype} if dtype is not None else {}
    problem = Poromechanics(params, mesh, markers, parser, device=device, **kwargs)
    W = problem.W
    bcs_s = [
        DirichletBC(W, "s", 0.0, markers=markers, tags=[XM], component=0),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[YM], component=1),
        DirichletBC(W, "s", 0.0, markers=markers, tags=[ZM], component=2),
    ]
    bcs_f = [
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[ZM]),
        DirichletBC(W, "f", [0.0, 0.0, 0.0], markers=markers, tags=[ZP]),
    ]
    bcs_p = [
        DirichletBC(W, "p", 0.0, markers=markers, tags=[t]) for t in (XM, XP, YM, YP, ZP)
    ]
    problem.set_bcs(bcs_s + bcs_f, bcs_p)
    return problem


# the overrides bench.py:88-105 gives swelling_3d at N=13
BENCH_OVERRIDES = {
    "pc type": "diagonal",
    "inner ksp type": "preonly",
    "inner pc type": "hypre",
    "inner iters": 1,
    "amg p drop": 0.05,
    "solver rtol": 1e-6,
    "solver atol": 1e-8,
    "solver maxiter": 100,
    "rhs mode": "loads-only",
    "pad multiple": 128,
    "dtype": "float32",
}

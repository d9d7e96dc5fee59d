"""Shared inputs of the port's kernel tests (CPU parity and the card), the
one subprocess the import checks of the port's tests share, and the
fixture that runs each CPU test file's BLAS on one thread.

Imports no jax, so the card-only tests can use it where jax is absent.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.ops.dia import Transposed

K1_CASES = ["test_dia_set_1024", "test_dia_set_3072", "solid_block_233", "transposed_inner_714"]
# K2: two offset sets of tests/test_dia.py's rmv cases at nrows 1024 and
# 2048, and the transposes of the N=3 build (prolongator, Transposed block)
K2_CASES = ["rmv_set_1024", "rmv_set_2048", "prolongator_L0", "transposed_block_714"]
K2_CPU_CASES = K2_CASES[:2]
CSR_CASES = ["square", "col_emb", "rect_wide", "rect_no_emb"]
# Edge shapes of the launch plan, (nd, nrows, ne, offsets) for K1 (ne the
# input length) and K2 (ne the output length): one diagonal; more
# diagonals than the plan's groups (a cluster of 8 on one tile); fewer
# diagonals than warps; fewer rows than a tile; lengths that are not whole
# 16-byte chunks; ne != nrows both ways; bands with no row inside.
EDGE_CASES = {
    "nd_1": (1, 640, 640, (3,)),
    "nd_over_groups": (600, 1000, 1000, tuple(range(-300, 300))),
    "nd_under_warps": (5, 4096, 4096, (-700, -1, 0, 2, 701)),
    "nrows_under_tile": (9, 50, 50, tuple(range(-4, 5))),
    "nrows_not_chunks": (7, 1001, 1001, (-37, -5, 0, 1, 3, 250, 999)),
    "ne_lt_nrows": (6, 1152, 776, (-5, 0, 1, 2, 3, 400)),
    "ne_gt_nrows": (6, 130, 1152, (-5, 0, 1, 2, 3, 900)),
    "far_bands": (5, 300, 260, (-900, -301, 0, 35, 700)),
}


def edge_case(name):
    """(data (nd, nrows), offsets, x (ne,), xt (nrows,), ne) in f64: the K1
    input x and the K2 input xt of one edge shape."""
    nd, nrows, ne, offs = EDGE_CASES[name]
    assert len(offs) == nd
    rng = np.random.default_rng(17)
    return rng.normal(size=(nd, nrows)), offs, rng.normal(size=ne), rng.normal(size=nrows), ne


def small_build():
    """The port's host build of swelling-3d N=3 with the bench overrides (f32)."""
    p = swelling_3d(3, overrides=BENCH_OVERRIDES, device="cpu")
    p._build_operators()
    return p


def banded_random(n, offsets, rng, density=0.8, m=None):
    m = n if m is None else m
    rows, cols, vals = [], [], []
    for o in offsets:
        i = np.arange(max(0, -o), min(n, m - o))
        i = i[rng.random(i.size) < density]
        rows.append(i)
        cols.append(i + o)
        vals.append(rng.normal(size=i.size))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, m),
    )


def offset_case(name, build):
    """(data (nd, nrows), offsets, x, nrows) in f64 for one K1 case; the
    offset sets of tests/test_dia.py:169-171 and of the N=3 build."""
    rng = np.random.default_rng(11)
    if name == "test_dia_set_1024":
        n, offs = 1024, (-300, -129, -128, -1, 0, 1, 127, 128, 301)
        return rng.normal(size=(len(offs), n)), offs, rng.normal(size=n), n
    if name == "test_dia_set_3072":
        n, offs = 3072, (-520, -42, 0, 5, 130, 515)
        return rng.normal(size=(len(offs), n)), offs, rng.normal(size=n), n
    if name == "solid_block_233":
        D = build.A_dev.block("s", "s")
        assert len(D.offsets) == 233
        return rng.normal(size=D.data.shape), D.offsets, rng.normal(size=D.ne), D.nrows
    # the >= 700-band Transposed coupling: the forward kernel on (dataT,
    # -offsets), a rectangular product (128 inputs -> 1152 outputs)
    T = build.A_dev.block("f", "p")
    assert isinstance(T, Transposed) and len(T.inner.offsets) >= 700
    D = T.inner
    assert D.dataT is not None and D.ne != D.nrows
    return (
        rng.normal(size=D.dataT.shape), tuple(-o for o in D.offsets),
        rng.normal(size=D.nrows), D.ne,
    )


def emb_case(rng, nf, nc, width):
    """Prolongator-like (nf, nc) block, banded under a column embedding."""
    emb = np.sort(rng.choice(nf, size=nc, replace=False))
    rows, cols, vals = [], [], []
    for j in range(nc):
        i = np.clip(emb[j] + np.arange(-width, width + 1), 0, nf - 1)
        rows.append(i)
        cols.append(np.full(i.size, j))
        vals.append(rng.normal(size=i.size))
    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nc),
    )
    return P, emb


def csr_case(name):
    """(CSR, col_emb or None) for one DIA storage case."""
    rng = np.random.default_rng(5)
    if name == "square":
        return banded_random(200, [-7, -3, -1, 0, 1, 2, 9], rng), None
    if name == "col_emb":
        return emb_case(rng, 120, 40, 2)
    if name == "rect_wide":
        # ne = ncols > nrows, no embedding
        return banded_random(96, [-5, 0, 3, 40, 77], rng, m=160), None
    # tests/test_dia.py:test_store_transpose_rect_no_emb
    rng = np.random.default_rng(12)
    n, m = 40, 64
    rows = np.repeat(np.arange(n), 2)
    cols = np.clip(rows + rng.integers(0, 20, size=rows.size), 0, m - 1)
    return sp.csr_matrix((rng.normal(size=rows.size), (rows, cols)), shape=(n, m)), None


def rmv_case(name, build):
    """(data (nd, nrows), offsets, x (nrows,), ne) in f64 for one K2 case."""
    rng = np.random.default_rng(13)
    if name == "rmv_set_1024":
        n, offs = 1024, (-300, -129, -128, -1, 0, 1, 127, 128, 301)
        return rng.normal(size=(len(offs), n)), offs, rng.normal(size=n), n
    if name == "rmv_set_2048":
        n, offs = 2048, (-520, -300, -42, 0, 5, 130, 515)
        return rng.normal(size=(len(offs), n)), offs, rng.normal(size=n), n
    if name == "prolongator_L0":
        P = build.pc.solve_s.mods["amg"].levels[0].P
        D = P.inner if isinstance(P, Transposed) else P
    else:
        # the Transposed coupling from K1_CASES on A's own layout:
        # 128 inputs -> 1152 outputs
        D = build.A_dev.block("f", "p").inner
        assert len(D.offsets) >= 700 and D.ne != D.nrows
    return rng.normal(size=D.data.shape), D.offsets, rng.normal(size=D.nrows), D.ne


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """numpy's and scipy's BLAS on one thread while a CPU test file runs, as
    the files run torch (``torch.set_num_threads(1)``): at these sizes more
    threads add CPU time and no speed.  Imported by each file; the limit
    lifts at the file's end."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


# One fresh interpreter runs the port four ways, each from a fresh import
# of porotpu_torch: swelling-3d N=2 in f64 with jax importable, then with
# jax unimportable; with jax still unimportable, that problem built with a
# solver cache path and restored from its file into a fresh problem; then
# the swelling driver as a module at N=2; then one cell of the robustness
# runner (its child's code) at N=2.  Each records the modules of jax and
# porotpu loaded by then.
_IMPORT_CHECK = """
import contextlib, io, json, runpy, sys, tempfile

def fresh():
    for m in [m for m in sys.modules if m.split('.')[0] == 'porotpu_torch']:
        del sys.modules[m]

def foreign():
    return sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'porotpu'))

out = {}
for blocked in (False, True):
    fresh()
    if blocked:
        sys.modules['jax'] = None
    from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
    p = swelling_3d(2, overrides=dict(BENCH_OVERRIDES, dtype='float64'), device='cpu')
    its = p.solve()
    out['jax_blocked' if blocked else 'jax_importable'] = dict(
        converged=bool(p.last_result.converged), iterations=its, foreign=foreign())
with tempfile.TemporaryDirectory() as d:
    over = dict(BENCH_OVERRIDES, dtype='float64')
    p = swelling_3d(2, overrides=dict(over, **{'solver cache path': d + '/s.pkl'}), device='cpu')
    fresh_its = p.solve()
    p.cache_writer.join(timeout=60)
    q = swelling_3d(2, overrides=over, device='cpu')
    restored = q.try_load_solver_cache(d + '/s.pkl')
    out['cache_restore'] = dict(restored=restored, iterations=q.solve(),
                                fresh_iterations=fresh_its, foreign=foreign())
fresh()
sys.argv = ['swelling', '-N', '2', '--device', 'cpu']
text = io.StringIO()
with contextlib.redirect_stdout(text):
    runpy.run_module('porotpu_torch.drivers.swelling', run_name='__main__')
out['driver'] = dict(stdout=text.getvalue(), foreign=foreign())
fresh()
from porotpu_torch.tools import robustness
with tempfile.TemporaryDirectory() as d:
    with contextlib.redirect_stdout(io.StringIO()):
        robustness.run_cell(robustness.GRID[0]._replace(N=2), 'cpu', '', d + '/cell.json')
    with open(d + '/cell.json') as fh:
        rec = json.load(fh)
out['robustness'] = dict(iterations=rec['iterations'], plain=rec['plain'], foreign=foreign())
print('IMPORT_CHECK ' + json.dumps(out))
"""


@functools.cache
def import_checks():
    """{"jax_importable" | "jax_blocked": {converged, iterations, foreign},
    "cache_restore": {restored, iterations, fresh_iterations, foreign},
    "driver": {stdout, foreign}, "robustness": {iterations, plain, foreign}} from
    one subprocess (see _IMPORT_CHECK)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PORO_PLATFORM", None)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK], cwd=repo, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("IMPORT_CHECK ")][-1]
    return json.loads(line.removeprefix("IMPORT_CHECK "))


# -- the row mesh: one gloo group of four ranks for tests/test_torch_parallel.py

# the full solves the group runs, as builder (a benchmarks function, or
# the swelling driver's flags), N, overrides (pad multiple 4 added;
# "options": entries added to the options file's database),
# whether the outer blocks and couplings store ELL, and the mesh sizes:
# porotpu's tests/test_parallel.py:66-92 cases, the 3-way one with ELL
# blocks (footing's ELL starts at N=10, and its solves make thousands of
# collectives: too slow for a CPU test), and the solver types and PCs of
# the other solve paths at the sizes of tests/test_torch_outer.py
PARALLEL_SOLVES = {
    "swelling_diagonal_hypre": ("swelling", 6, {
        "pc type": "diagonal", "inner pc type": "hypre", "solver rtol": 1e-8,
        "solver atol": 1e-12}, False, (2, 4)),
    "swelling_3way_lu": ("swelling", 4, {
        "pc type": "diagonal 3-way", "inner pc type": "lu", "solver rtol": 1e-8,
        "solver atol": 1e-12, "solver maxiter": 400}, False, (2, 4)),
    "swelling_3way_lu_ell": ("swelling", 4, {
        "pc type": "diagonal 3-way", "inner pc type": "lu", "solver rtol": 1e-8,
        "solver atol": 1e-12, "solver maxiter": 400}, True, (2, 4)),
    "swelling_aar": (["--solver-type", "aar"], 3, {}, False, (2, 4)),
    "swelling_inexact_accel1": (["--petsc-options", "petsc-options-inexact", "--solver-type",
                                 "aar", "--inner-accel-order", "1"], 4, {}, False, (2, 4)),
    # tests/test_torch_qexact.py's apply: -fp_lu_fallback_iters 5
    "swelling_qexact": (["--petsc-options", "petsc-options-exact-iterative"], 2, {
        "options": {"fp_lu_fallback_iters": "5"}}, False, (2, 4)),
    "swelling_cg_maxiter20": (["--solver-type", "cg"], 3, {"solver maxiter": 20}, False,
                              (2, 4)),
    "swelling_cg_4_chunks": (["--solver-type", "cg"], 3, {
        "solver maxiter": 20, "solver chunk": 5}, False, (2, 4)),
}
PARALLEL_WORLD = 4
# the cases that stop unconverged at their maxiter, sharded and unsharded
# alike: outer cg on the nonsymmetric system (tests/test_torch_outer.py)
UNCONVERGED_SOLVES = ("swelling_cg_maxiter20", "swelling_cg_4_chunks")


def parallel_problem(name, device="cpu", **more):
    """The padded (pad multiple 4) problem of one PARALLEL_SOLVES case,
    its parameters updated by ``more``."""
    import porotpu_torch.models.poromechanics as pm
    from porotpu_torch.models import benchmarks

    builder, N, ov, ell, _ = PARALLEL_SOLVES[name]
    ov = dict(ov, **{"pad multiple": PARALLEL_WORLD}, **more)
    options = ov.pop("options", {})
    if isinstance(builder, list):
        from porotpu_torch.drivers import swelling

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        flags = [os.path.join(repo, f) if f.startswith("petsc-options") else f
                 for f in builder]
        p = swelling.setup(["-N", str(N), *flags, "--device", device], overrides=ov)
        # the driver's flags are applied over the overrides: apply them again
        p.parameters.update(ov)
        for key, val in options.items():
            p.parameters["options db"].set(key, val)
    else:
        p = getattr(benchmarks, builder)(N, overrides=ov, device=device)
    if ell:
        build = p._build_operators

        def build_ell():
            dm = pm.device_matrix
            pm.device_matrix = functools.partial(dm, max_diags=0, dense_max=0)
            try:
                build()
            finally:
                pm.device_matrix = dm

        p._build_operators = build_ell
    return p


def _rel(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


@functools.cache
def _host_build(name):
    """A problem built on the host, once a rank for both mesh sizes."""
    if name == "footing":
        # the inexact options file: preonly AMG, one V-cycle a block
        from porotpu_torch.drivers import footing

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        p = footing.setup(["-N", "4", "--petsc-options",
                           os.path.join(repo, "petsc-options-inexact"), "--pc-type",
                           "undrained", "--device", "cpu"],
                          overrides={"pad multiple": PARALLEL_WORLD})
    elif name == "swelling":
        # a coarse size below the fields', so that each AMG has a sharded level 0
        p = parallel_problem("swelling_diagonal_hypre", **{"amg coarse size": 100})
    else:
        p = parallel_problem(name)
    p._build_operators()
    return p


def _rank_cases(mesh, rng):
    """The checks of one mesh, a dict of results: a halo product's
    exchanges, an outer cg and the full solves on every mesh; the
    products and PC applies on the whole group."""
    import time

    import torch

    from porotpu_torch.ops import dia, dia_kernel
    from porotpu_torch.ops.dia import DIA
    from porotpu_torch.ops.sparse import ELL
    from porotpu_torch.parallel import sharding
    from porotpu_torch.precond.amg import AMG
    from porotpu_torch.solvers.cg import cg

    out = {"products": {}, "applies": {}, "solves": {}, "seconds": {}}
    t0 = time.perf_counter()

    def field_vec(sizes):
        x = torch.from_numpy(rng.normal(size=sum(sizes)))
        return x, sharding.shard_vector(x, mesh, sizes)

    def hold_products(label, op):
        sh = sharding.shard_ell(op, mesh)
        n, m = op.shape
        x, xl = field_vec((m,))
        y, yl = field_vec((n,))
        out["products"][label + "/matvec"] = _rel(sh.matvec(xl), mesh.slab(op.matvec(x)))
        out["products"][label + "/rmatvec"] = _rel(sh.rmatvec(yl), mesh.slab(op.rmatvec(y)))

    def hold_pc(label, p):
        b, bl = field_vec(p.padded_sizes)
        pc = sharding.shard_operator(p.pc, mesh)
        out["applies"][label] = _rel(pc(bl), sharding.shard_vector(p.pc(b), mesh,
                                                                   p.padded_sizes))

    with torch.inference_mode():
        p = _host_build("swelling")
        A = p.A_dev
        # exchanges of one square halo product, this rank's count
        sh = sharding.shard_ell(A.block("s", "s"), mesh)
        sharding.reset_collectives()
        xs = field_vec((A.sizes["s"],))[1]
        dia_kernel.reset_counts()
        y = sh.matvec(xs)
        out["halo"] = {"dist": sh.dist[0], "exchanges": sum(
            n for (op, _), n in sharding.COLLECTIVES.items() if op == "exchange")}
        # gloo's own choice (one launch after the wait), then the split forced
        launches = [dia_kernel.COUNTS["plain"]]
        own, mesh.halo_split = mesh.halo_split, True
        dia_kernel.reset_counts()
        y_split = sh.matvec(xs)
        mesh.halo_split = own
        launches.append(dia_kernel.COUNTS["plain"])
        out["halo_split"] = {"mesh": own, "interior": sh.split, "launches": launches,
                             "equal": bool(torch.equal(y, y_split))}
        # outer cg on a symmetric banded operator, reduced over the ranks
        S = banded_random(128, (-5, -2, 0, 2, 5), rng)
        D = DIA.from_csr((S + S.T + 20 * sp.eye(128)).tocsr(), torch.float64)
        b, bl = field_vec((128,))
        res1 = cg(D.matvec, b, rtol=1e-10, maxiter=200)
        res2 = cg(sharding.shard_ell(D, mesh).matvec, bl, rtol=1e-10, maxiter=200, mesh=mesh)
        out["solves"]["outer cg"] = {
            "iterations": res2.iters, "iterations_unsharded": res1.iters,
            "converged": bool(res2.converged),
            "x_rel": float(torch.linalg.norm(mesh.all_gather(res2.x) - res1.x)
                           / torch.linalg.norm(res1.x))}

        if mesh.world == PARALLEL_WORLD:
            for r in A.sizes:
                for c in A.sizes:
                    if A.block(r, c) is not None:
                        hold_products(f"swelling A {r}{c} {type(A.block(r, c)).__name__}",
                                      A.block(r, c))
            amg = p.pc.solve_s.mods["amg"]
            assert len(amg.levels) >= 2
            hold_products("swelling solid AMG L0 A", amg.levels[0].A)
            for label, lvl0 in (("solid", amg.levels[0]),
                                ("fluid", p.pc.solve_fp.solve_f.mods["amg"].levels[0])):
                P = sharding.shard_ell(lvl0.P, mesh, False)
                xc = torch.from_numpy(rng.normal(size=P.shape[1]))
                r = torch.from_numpy(rng.normal(size=P.shape[0]))
                name = f"swelling {label} AMG L0 P ({type(lvl0.P).__name__})"
                out["products"][name + "/matvec"] = _rel(P.matvec(xc),
                                                         mesh.slab(lvl0.P.matvec(xc)))
                out["products"][name + "/rmatvec"] = _rel(P.rmatvec(mesh.slab(r)),
                                                          lvl0.P.rmatvec(r))
            hold_products("swelling Schur Apf", p.pc.solve_fp.Apf)
            hold_pc("2-way block PC (AMG levels)", p)
            bs, bsl = field_vec((p.padded_sizes[0],))
            out["applies"]["solid AMG V-cycle"] = _rel(sharding.shard_amg(amg, mesh)(bsl),
                                                       mesh.slab(amg(bs)))
            M = torch.from_numpy(rng.normal(size=(40, 40)) + 40 * np.eye(40))
            inv, v = torch.linalg.inv(M), torch.from_numpy(rng.normal(size=40))
            out["applies"]["AMG of no level"] = _rel(
                sharding.shard_amg(AMG([], inv), mesh)(mesh.slab(v)), mesh.slab(inv @ v))
            hold_pc("3-way block PC (lu)", _host_build("swelling_3way_lu"))
            # footing: wide bands (every banded block gathers at W=4) and its
            # coupling blocks stored ELL
            pf = _host_build("footing")
            hold_pc("footing 2-way block PC", pf)
            Ab = pf._bc_applied_blocks()[0]
            for rc in (("f", "p"), ("p", "f"), ("s", "p")):
                hold_products(f"footing {''.join(rc)} ELL",
                              ELL.from_csr(Ab[rc], torch.float64, store_transpose=True))
    out["seconds"]["products, applies, cg"] = time.perf_counter() - t0

    sharding.reset_collectives()
    dia.MESH_PRODUCTS.clear()
    for name, (*_, worlds) in PARALLEL_SOLVES.items():
        if mesh.world not in worlds:
            continue
        t0 = time.perf_counter()
        q = parallel_problem(name)
        q.create_solver(mesh)
        q.first_timestep = False
        its = q.solve_time_step(q.t0 + q.parameters["dt"])
        out["solves"][name] = {"iterations": its, "converged": bool(q.last_result.converged),
                               "x": q.unpadded_solution().tolist(),
                               "ell": sum(type(m).__name__ == "ELL" for m in q.A_dev.modules())}
        out["seconds"][name] = time.perf_counter() - t0
    out["all_gather_max"] = max(
        (n for (op, n) in sharding.COLLECTIVES if op == "all_gather"), default=0)
    out["field_max"] = max(max(parallel_problem(n).padded_sizes) for n in PARALLEL_SOLVES)
    out["mesh_products"] = sorted(f"{k}/{p}/{e}" for k, p, e in dia.MESH_PRODUCTS)
    return out


# the solve a mesh over two hosts repeats (rank order: hosts 0 0 1 1)
HOSTS_CASE = "swelling_3way_lu"


def _host_cases(rank):
    """The group as two hosts of two ranks: HOSTS_CASE's solve and its
    exchanges, all and host-crossing; then the layouts that raise."""
    import torch

    from porotpu_torch.parallel import sharding

    out = {}
    mesh = sharding.solver_mesh(PARALLEL_WORLD, "cpu", n_hosts=2, host=f"host{rank // 2}")
    q = parallel_problem(HOSTS_CASE)
    q.create_solver(mesh)
    q.first_timestep = False
    sharding.reset_collectives()
    with torch.inference_mode():
        out["iterations"] = q.solve_time_step(q.t0 + q.parameters["dt"])
    out["x"] = q.unpadded_solution().tolist()
    out["exchanges"] = sum(n for (op, _), n in sharding.COLLECTIVES.items() if op == "exchange")
    out["host_exchanges"] = sum(n for (op, _), n in sharding.COLLECTIVES.items()
                                if op == "host_exchange")
    out["raises"] = {}
    for label, kw in (("interleaved", dict(n_hosts=2, host=f"host{rank % 2}")),
                      ("three hosts", dict(n_hosts=3, host=f"host{rank}"))):
        try:
            sharding.solver_mesh(PARALLEL_WORLD, "cpu", **kw)
        except ValueError as e:
            out["raises"][label] = str(e)
    return out


def parallel_rank(rank, init_method, out_path):
    """One rank of the test group: the cases on the whole group (4 ranks),
    on its half (2 ranks) and on the group as two hosts, written as JSON
    to ``out_path``."""
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from porotpu_torch.parallel import RowMesh, solver_mesh

    mesh4 = solver_mesh(PARALLEL_WORLD, "cpu", rank=rank, init_method=init_method, timeout=60)
    try:
        # the halves of the group, ranks 0-1 and 2-3, each a mesh of two
        mesh2 = RowMesh(dist.new_subgroups(group_size=2)[0], mesh4.device)
        out = {"rank": rank}
        for mesh in (mesh2, mesh4):
            # one seed on every rank: each slab is of the same whole vector
            out[str(mesh.world)] = _rank_cases(mesh, np.random.default_rng(mesh.world))
        out["hosts"] = _host_cases(rank)
        out["foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "porotpu"))
    finally:
        mesh4.close()
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_parallel_group(tmp):
    """Start the group's four ranks (a ``file://`` rendezvous in ``tmp``);
    returns their processes and result paths."""
    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests)
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    init = "file://" + os.path.join(str(tmp), "rendezvous")
    procs, paths = [], []
    for r in range(PARALLEL_WORLD):
        path = os.path.join(str(tmp), f"rank{r}.json")
        code = (f"import sys; sys.path.insert(0, {tests!r}); from torch_k1_cases import "
                f"parallel_rank; parallel_rank({r}, {init!r}, {path!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=repo, env=env,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                      text=True))
        paths.append(path)
    return procs, paths


def join_parallel_group(procs, paths, timeout=300):
    """The ranks' results, in rank order; raises with a rank's stderr when
    it failed."""
    errs = [p.communicate(timeout=timeout)[1] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}: {errs[r][-3000:]}"
    out = []
    for path in paths:
        with open(path) as f:
            out.append(json.load(f))
    return out

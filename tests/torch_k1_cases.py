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

"""Shared inputs of the port's kernel tests (CPU parity and the card).

Imports no jax, so the card-only tests can use it where jax is absent.
"""

import numpy as np
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

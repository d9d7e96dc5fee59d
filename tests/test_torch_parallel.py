"""The port's row sharding (porotpu_torch/parallel, the mesh paths of
ops/dia.py and ops/sparse.py) against the unsharded port, on the CPU.

Without processes: each rank's local products (its slab, its window,
its shifted offsets, through the plain versions of K1 and K2) against
the unsharded product, for W in {2, 4}.  Then one gloo group of four
ranks, spawned once for the file (tests/torch_k1_cases.py:parallel_rank),
runs every case on the whole group and on its two halves: products, the
AMG and block PC applies and full solves against the unsharded port, the
exchanges of a halo product, the longest all-gather, and the modules it
imported.  One porotpu solve at the same pad multiple holds the
unsharded port's count, while the ranks run.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from porotpu_torch.drivers import swelling as swelling_driver
from porotpu_torch.ops import dia_kernel
from porotpu_torch.ops.dia import (
    DIA, Transposed, halo_fold, halo_matvec_local, halo_rmatvec_local,
)
from porotpu_torch.ops.sparse import ELL
from porotpu_torch.parallel import sharding
from porotpu_torch.tools.shard_walk import SlabMesh
from torch_k1_cases import (  # noqa: F401 (one_blas_thread: a fixture)
    PARALLEL_SOLVES, UNCONVERGED_SOLVES, banded_random, join_parallel_group, one_blas_thread, parallel_problem,
    start_parallel_group,
)

torch.set_num_threads(1)
WORLDS = (2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE_CASES = [(case, W) for case, (*_, worlds) in PARALLEL_SOLVES.items() for W in worlds]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks, started once for the file."""
    procs, paths = start_parallel_group(tmp_path_factory.mktemp("gloo"))
    yield procs, paths
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def reference():
    """The unsharded port's count and x of each full solve, same padding."""
    out = {}
    with torch.inference_mode():
        for name in PARALLEL_SOLVES:
            p = parallel_problem(name)
            its = p.solve()
            out[name] = (its[0], p.unpadded_solution(), bool(p.last_result.converged))
    return out


@pytest.fixture(scope="module")
def ranks(group):
    return join_parallel_group(*group)


def test_porotpu_unsharded_count_matches_the_port(group, reference):
    """porotpu's unsharded solve of the 3-way lu case at pad multiple 4
    (computed while the ranks run) takes the unsharded port's count."""
    from porotpu.models import benchmarks as jbench

    _, N, ov, _, _ = PARALLEL_SOLVES["swelling_3way_lu"]
    jp = jbench.swelling(Nelements=N, overrides=dict(ov, **{"pad multiple": 4}))
    its = jp.solve()
    assert its[0] == reference["swelling_3way_lu"][0]
    x = np.asarray(jp.sol)[jp.pad_index]
    ref = reference["swelling_3way_lu"][1]
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-6


# -- each rank's local compute, without processes -----------------------------


def _square(n, offsets, seed):
    A = banded_random(n, offsets, np.random.default_rng(seed))
    return DIA.from_csr(A, torch.float64), A


@pytest.mark.parametrize("W", WORLDS)
def test_halo_matvec_is_the_unsharded_product_bit_for_bit(W):
    """K1 (plain) on each rank's window [from_left | x_loc | from_right],
    offsets shifted by hl: the slabs of the unsharded matvec, bit for bit."""
    D, _ = _square(128, (-9, -3, -1, 0, 2, 5, 11), 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=128))
    want = D.matvec(x)
    hl, hr = 9, 11
    xpad = torch.cat([x.new_zeros(hl), x, x.new_zeros(hr)])
    for r in range(W):
        sh = sharding.shard_ell(D, SlabMesh(r, W))
        assert sh.dist[0] == "halo" and sh.halo == (hl, hr)
        nloc = 128 // W
        window = xpad[r * nloc : r * nloc + hl + nloc + hr]
        y = halo_matvec_local(sh.data, sh.shift, sh.shift_dev, window)
        assert torch.equal(y, want[r * nloc : (r + 1) * nloc])


class ExchangeStub(SlabMesh):
    """A rank of a mesh whose exchange hands back its neighbours' halos of a
    whole vector ``x`` (zeros with ``zero``), recording in ``events`` when
    the exchange starts and when it is waited on."""

    def __init__(self, rank, world, x, events, zero=False):
        super().__init__(rank, world)
        self.x, self.events, self.zero = x, events, zero

    def exchange_start(self, to_left, to_right):
        self.events.append("start")
        hl, hr, nloc = to_right.shape[0], to_left.shape[0], self.x.shape[0] // self.world
        xpad = torch.cat([self.x.new_zeros(hl), self.x, self.x.new_zeros(hr)])
        r0 = self.rank * nloc
        halos = (xpad[r0 : r0 + hl], xpad[hl + r0 + nloc : hl + r0 + nloc + hr])
        if self.zero:
            halos = tuple(torch.zeros_like(h) for h in halos)
        events = self.events

        class Pending:
            def wait(self):
                events.append("wait")
                return halos

        return Pending()


SPLIT_CASES = [(128, W) for W in WORLDS] + [(120, 4)]  # 120 / 4: a slab of 30, ragged


@pytest.mark.parametrize("n, W", SPLIT_CASES)
def test_halo_matvec_launches_its_interior_before_the_wait(n, W, monkeypatch):
    """The split halo matvec (porotpu's sweep_split): the exchange starts,
    the slab's K1 launch runs on x_loc alone, then the wait, then one small
    K1 launch for the hl top rows and one for the hr bottom rows.  A slab
    no wider than its halos, or one rank, waits first and launches once."""
    D, _ = _square(n, (-9, -3, -1, 0, 2, 5, 11), 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=n))
    events, mv = [], dia_kernel.mv

    def recorded(data, offsets, offsets_dev, xe, nrows, groups_of=None):
        events.append(("K1", nrows, groups_of))
        return mv(data, offsets, offsets_dev, xe, nrows, groups_of)

    monkeypatch.setattr(dia_kernel, "mv", recorded)
    nloc = n // W
    for r in range(W):
        events.clear()
        sh = sharding.shard_ell(D, ExchangeStub(r, W, x, events))
        assert sh.split
        sh.matvec(x[r * nloc : (r + 1) * nloc])
        assert events == ["start", ("K1", nloc, None), "wait", ("K1", 9, nloc),
                          ("K1", 11, nloc)]
    for world, size in ((1, n), (W, 16 * W)):
        D1, _ = _square(size, (-9, -3, -1, 0, 2, 5, 11), 1)
        x1 = torch.from_numpy(np.random.default_rng(2).normal(size=size))
        events.clear()
        sh = sharding.shard_ell(D1, ExchangeStub(0, world, x1, events))
        assert not sh.split
        sh.matvec(x1[: size // world])
        assert events == ["start", "wait", ("K1", size // world, None)]


@pytest.mark.parametrize("n, W", SPLIT_CASES)
def test_split_interior_rows_do_not_read_the_halos(n, W):
    """With the received halos zeroed, the interior rows [hl, nloc - hr) of
    the split product are unchanged and its boundary rows are not."""
    D, _ = _square(n, (-9, -3, -1, 0, 2, 5, 11), 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=n))
    nloc, hl, hr = n // W, 9, 11
    for r in range(W):
        x_loc = x[r * nloc : (r + 1) * nloc]
        y = sharding.shard_ell(D, ExchangeStub(r, W, x, [])).matvec(x_loc)
        y0 = sharding.shard_ell(D, ExchangeStub(r, W, x, [], zero=True)).matvec(x_loc)
        assert torch.equal(y[hl : nloc - hr], y0[hl : nloc - hr])
        if r > 0:
            assert not torch.equal(y[:hl], y0[:hl])
        if r < W - 1:
            assert not torch.equal(y[nloc - hr :], y0[nloc - hr :])


@pytest.mark.parametrize("n, W", SPLIT_CASES)
def test_split_halo_matvec_is_the_unsharded_product_bit_for_bit(n, W):
    """The split product, interior launch and fix-ups (plain K1), on each
    rank: the slabs of the unsharded matvec bit for bit, on a ragged slab
    too (the plain version sums a row alike at any width)."""
    D, _ = _square(n, (-9, -3, -1, 0, 2, 5, 11), 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=n))
    want, nloc = D.matvec(x), n // W
    for r in range(W):
        sh = sharding.shard_ell(D, ExchangeStub(r, W, x, []))
        assert torch.equal(sh.matvec(x[r * nloc : (r + 1) * nloc]),
                           want[r * nloc : (r + 1) * nloc])


@pytest.mark.parametrize("W", WORLDS)
def test_halo_transpose_folds_to_the_unsharded_product(W):
    """K2 (plain) over each rank's window, then the neighbours' overflows
    added in: the unsharded transpose to rounding."""
    D, _ = _square(96, (-9, -3, 0, 4, 11), 3)
    y = torch.from_numpy(np.random.default_rng(4).normal(size=96))
    want = D.rmatvec(y)
    nloc, hl, hr = 96 // W, 9, 11
    accs = []
    for r in range(W):
        sh = sharding.shard_ell(D, SlabMesh(r, W))
        accs.append(halo_rmatvec_local(sh.data, sh.shift, sh.shift_dev,
                                       y[r * nloc : (r + 1) * nloc], hl, hr))
    for r in range(W):
        from_left = accs[r - 1][hl + nloc :] if r else torch.zeros(hr, dtype=y.dtype)
        from_right = accs[r + 1][:hl] if r + 1 < W else torch.zeros(hl, dtype=y.dtype)
        got = halo_fold(accs[r], hl, hr, from_left, from_right)
        np.testing.assert_allclose(got, want[r * nloc : (r + 1) * nloc], rtol=0,
                                   atol=1e-13 * float(want.abs().max()))


def _embedded(seed):
    """A banded block of 128 lattice rows whose 32 columns embed into the
    lattice (every fourth slot), and the embedding."""
    rng = np.random.default_rng(seed)
    emb = np.arange(32) * 4 + 1
    rows, cols = [], []
    for j, e in enumerate(emb):
        for i in range(max(0, e - 6), min(128, e + 7)):
            rows.append(i)
            cols.append(j)
    A = sp.csr_matrix((rng.normal(size=len(rows)), (rows, cols)), shape=(128, 32))
    return DIA.from_csr(A, torch.float64, col_emb=emb), A


@pytest.mark.parametrize("W", WORLDS)
def test_embedded_and_transposed_blocks(W):
    """An embedded block: each rank scatters its window's range of the
    replicated input and runs K1 on it (bit for bit); its transpose, the
    product of a Transposed block, takes the window's range of each rank's
    K2 output at the embedding and sums it over the ranks."""
    D, A = _embedded(5)
    rng = np.random.default_rng(6)
    x, y = torch.from_numpy(rng.normal(size=32)), torch.from_numpy(rng.normal(size=128))
    T = Transposed(D)
    want_mv, want_t = D.matvec(x), T.matvec(y)
    np.testing.assert_allclose(want_t, A.T @ y.numpy(), rtol=1e-12)
    nloc, total = 128 // W, torch.zeros(32, dtype=y.dtype)
    for r in range(W):
        sh = sharding.shard_ell(T, SlabMesh(r, W)).inner
        hl, hr = sh.halo
        assert sh.dist[0] == "halo"
        window = x.new_zeros(hl + nloc + hr)
        window[sh.win_dst] = x[sh.win_src]
        got = halo_matvec_local(sh.data, sh.shift, sh.shift_dev, window)
        assert torch.equal(got, want_mv[r * nloc : (r + 1) * nloc])
        acc = halo_rmatvec_local(sh.data, sh.shift, sh.shift_dev,
                                 y[r * nloc : (r + 1) * nloc], hl, hr)
        total[sh.win_src] += acc[sh.win_dst]
    np.testing.assert_allclose(total, want_t, rtol=0, atol=1e-13 * float(want_t.abs().max()))


@pytest.mark.parametrize("W", WORLDS)
def test_gather_fallback(W):
    """A band wider than a slab gathers: K1 and K2 on the slab with offsets
    shifted by rank * nloc, over the whole input."""
    D, _ = _square(64, (-40, -1, 0, 3, 33), 7)
    rng = np.random.default_rng(8)
    x, y = torch.from_numpy(rng.normal(size=64)), torch.from_numpy(rng.normal(size=64))
    want_mv, want_t = D.matvec(x), D.rmatvec(y)
    nloc, total = 64 // W, torch.zeros(64, dtype=y.dtype)
    for r in range(W):
        sh = sharding.shard_ell(D, SlabMesh(r, W))
        assert sh.dist[0] == "gather" and sh.shift == tuple(o + r * nloc for o in D.offsets)
        got = dia_kernel.mv(sh.data, sh.shift, sh.shift_dev, x, nloc)
        assert torch.equal(got, want_mv[r * nloc : (r + 1) * nloc])
        total += dia_kernel.rmv(sh.data, sh.shift, sh.shift_dev,
                                y[r * nloc : (r + 1) * nloc], 64)
    np.testing.assert_allclose(total, want_t, rtol=0, atol=1e-13 * float(want_t.abs().max()))


@pytest.mark.parametrize("W", WORLDS)
def test_ell_slabs(W):
    """ELL keeps its rows' slab and global columns: the matvec gathers the
    whole input, the transpose (its stored transposed layout, rebuilt for
    the slab) sums over the ranks."""
    rng = np.random.default_rng(9)
    A = sp.random(48, 40, density=0.2, random_state=rng, format="csr") + sp.eye(48, 40)
    E = ELL.from_csr(A, torch.float64, store_transpose=True)
    x, y = torch.from_numpy(rng.normal(size=40)), torch.from_numpy(rng.normal(size=48))
    nloc, total = 48 // W, torch.zeros(40, dtype=y.dtype)
    for r in range(W):
        sh = sharding.shard_ell(E, SlabMesh(r, W))
        assert sh.shape == (48, 40) and sh.data.shape[0] == nloc
        got = (sh.data * x[sh.cols]).sum(1)
        np.testing.assert_array_equal(got, E.matvec(x)[r * nloc : (r + 1) * nloc])
        total += (sh.dataT * y[r * nloc : (r + 1) * nloc][sh.colsT]).sum(1)
    np.testing.assert_allclose(total, A.T @ y.numpy(), rtol=0, atol=1e-13 * float(total.abs().max()))


def test_every_solver_configuration_builds_on_a_mesh():
    """The solver types cg and aar, inner accel order and the fgmres+fs fp
    solve build on a mesh (here of one rank, without processes); a field
    size the world does not divide raises."""
    for ov in ({"solver type": "cg"}, {"solver type": "aar"}, {"inner accel order": 1}):
        p = parallel_problem("swelling_3way_lu")
        p.parameters.update(ov)
        p.create_solver(SlabMesh(0, 1))
    q = swelling_driver.setup(["-N", "2", "--petsc-options",
                               os.path.join(REPO, "petsc-options-exact-iterative"),
                               "--device", "cpu"])
    q.create_solver(SlabMesh(0, 1))
    fp = q.pc.solve_fp
    assert fp.kind == "fgmres+fs" and fp.mesh is not None
    assert type(fp.mods["A"]).__name__ == "FieldMatrix"
    assert fp.mods["fs"].solve_f.mesh is not None
    with pytest.raises(ValueError, match="pad multiple"):
        parallel_problem("swelling_3way_lu").create_solver(SlabMesh(0, 3))


@pytest.mark.parametrize("expect, converged, unsharded, guard, fails", [
    (True, True, True, True, 0),
    (True, False, False, False, 2),  # both stopped at maxiter: count and guard fail
    (True, True, False, True, 1),
    (False, False, False, False, 0),  # declared: held to the count, the stop and x
    (False, True, True, True, 1),
])
def test_multichip_requires_convergence_unless_declared(expect, converged, unsharded, guard,
                                                        fails):
    """tools/multichip.py's check: both solves must converge and meet the
    guard, unless the run declares that both stop at their maxiter."""
    from porotpu_torch.tools import multichip

    out = {"iterations": 20, "iterations_unsharded": 20, "converged": converged,
           "converged_unsharded": unsharded, "expect_converged": expect, "x_rel": 0.0,
           "x_rtol": 1e-8, "guard_met": guard, "guard_abs": 1.0, "guard_rel": 1.0,
           "foreign": [], "all_gather_max": 1, "field_max": 1}
    assert len(multichip.check(out)) == fails


def test_every_driver_tree_shards(capsys):
    """The grid's 12 configurations and the five drivers' defaults at N=2
    shard without processes (``tools/shard_walk.py``); none holds an
    embedded Transposed into a replicated space, the layout shard_ell
    does not port."""
    from porotpu_torch.tools import shard_walk

    assert shard_walk.main(["--ns", "2"]) == 0
    out = capsys.readouterr().out
    assert "17 trees, 0 raised" in out and "embedded" not in out


# -- the gloo group -------------------------------------------------------------


@pytest.mark.parametrize("case, W", SOLVE_CASES)
def test_sharded_solve_matches_unsharded(ranks, reference, case, W):
    """The unsharded port's outer count and x within 1e-8 relative (1e-6
    for the 3-way lu case: porotpu's bounds, tests/test_parallel.py:76, 92),
    on every rank; converged, but for the cases that stop at their maxiter
    on both sides (UNCONVERGED_SOLVES)."""
    its, x_ref, converged = reference[case]
    want = case not in UNCONVERGED_SOLVES
    assert converged == want
    tol = 1e-6 if case.startswith("swelling_3way_lu") else 1e-8
    for rank in ranks:
        got = rank[str(W)]["solves"][case]
        assert got["converged"] == want and got["iterations"] == its, (
            got["iterations"], its)
        x = np.asarray(got["x"])
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < tol


def test_products_and_pc_applies_match_unsharded(ranks):
    """Every block of the swelling operator, the solid and fluid AMGs'
    level-0 A and P, the Schur coupling, footing's coupling blocks stored
    ELL, the AMG V-cycle and the 2-way and 3-way block PC applies
    (swelling, footing): each rank's slab within 1e-12 of max|y| of the
    unsharded result (f64)."""
    for rank in ranks:
        res = rank["4"]
        for label, err in {**res["products"], **res["applies"]}.items():
            assert err <= 1e-12, (rank["rank"], label, err)
        assert len(res["applies"]) == 5
        assert sum("ELL" in k for k in res["products"]) == 6


@pytest.mark.parametrize("W", WORLDS)
def test_halo_product_makes_two_exchanges(ranks, W):
    """One square halo matvec: one exchange a direction on every rank
    (porotpu's test_sharded_dia_halo_is_aggregated)."""
    for rank in ranks:
        assert rank[str(W)]["halo"] == {"dist": "halo", "exchanges": 2}


@pytest.mark.parametrize("W", WORLDS)
def test_gloo_halo_matvec_waits_then_launches_once(ranks, W):
    """On gloo, whose wait holds the host, a halo matvec waits for its
    exchange and makes one K1 launch (RowMesh.halo_split is NCCL's); with
    the split forced it makes three (interior, two fix-ups) where the slab
    is wider than its halos (at W=2; at W=4 the solid block's is not) and
    gives the same product bit for bit."""
    for rank in ranks:
        got = rank[str(W)]["halo_split"]
        assert got["interior"] == (W == 2)
        assert got == {"mesh": False, "interior": W == 2, "launches": [1, 3 if W == 2 else 1],
                       "equal": True}


@pytest.mark.parametrize("W", WORLDS)
def test_outer_cg_reduces_over_the_ranks(ranks, W):
    got = ranks[0][str(W)]["solves"]["outer cg"]
    assert got["converged"] and got["iterations"] == got["iterations_unsharded"]
    assert got["x_rel"] < 1e-8


def test_two_host_mesh_solves_as_the_row_mesh(ranks):
    """The four ranks as two hosts (ranks 0-1, 2-3): the same 1-D partition,
    so the solve equals the 1-D mesh's bit for bit, and only the pair of
    ranks (1, 2) sends across the host boundary, one message a halo
    product each way (porotpu's tests/test_parallel.py:95-150)."""
    from torch_k1_cases import HOSTS_CASE

    for rank in ranks:
        flat, got = rank["4"]["solves"][HOSTS_CASE], rank["hosts"]
        assert got["iterations"] == flat["iterations"] and got["x"] == flat["x"]
    crossing = [r["rank"] for r in ranks if r["hosts"]["host_exchanges"]]
    assert crossing == [1, 2]
    assert ranks[1]["hosts"]["host_exchanges"] == ranks[2]["hosts"]["host_exchanges"]
    # each crossing rank sends one of its two messages a halo product across
    assert 0 < 2 * ranks[1]["hosts"]["host_exchanges"] == ranks[1]["hosts"]["exchanges"]


def test_host_layouts_that_raise(ranks):
    """An interleaved host layout (hosts 0 1 0 1) is not host-major, and four
    ranks do not divide into three hosts: ValueError on every rank."""
    for rank in ranks:
        raised = rank["hosts"]["raises"]
        assert "not host-major" in raised["interleaved"]
        assert "do not divide into 3 hosts" in raised["three hosts"]


def test_ell_case_stores_ell(ranks):
    assert ranks[0]["4"]["solves"]["swelling_3way_lu_ell"]["ell"] > 0


def test_no_all_gather_longer_than_a_field(ranks):
    for rank in ranks:
        for W in WORLDS:
            res = rank[str(W)]
            assert 0 < res["all_gather_max"] <= res["field_max"]
            kinds = {m.split("/")[0] for m in res["mesh_products"]}
            assert "halo" in kinds


def test_ranks_import_no_jax_or_porotpu(ranks):
    assert [r["foreign"] for r in ranks] == [[]] * 4

"""Port parity for ROADMAP M7.5: the solver cache, the solution export and
the mesh files, porotpu_torch against porotpu on the CPU.

- The solver cache: a restored problem takes a fresh build's iterations
  and gives its solution bit for bit (swelling N=3 f64 at the defaults,
  and the bench path's ``build_problem`` at N=2 in f32); a restore under
  another ``inner iters`` equals a fresh build with that count; garbage,
  a stale schema, a truncated pickle, a wrong tree and a file of the
  previous schema holding an ELL without its transposed layout miss and
  rebuild (as porotpu's tests/test_io.py:81-106); the port's bench cache files
  never take porotpu's names.  That a restore imports neither jax nor
  porotpu is checked in the shared subprocess of tests/torch_k1_cases.py.
- The writers: the VTU/PVD and XDMF/HDF5 files of the port's writers
  equal porotpu's on the same mesh and fields, their structure exactly
  and their numbers to 1e-12 relative.
- The mesh files: the round trip, ``prolateGeometry``, and a mesh written
  by either package read by the other.
- A checkpoint round trip at the problem's dtype; the crossing of
  checkpoints between the packages is in tests/test_torch_drivers.py.
"""

import os
import pickle
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from porotpu.fem import meshio as jmeshio
from porotpu.fem.mesh import generate_cube as jgenerate_cube
from porotpu.fem.mesh import generate_square as jgenerate_square
from porotpu.utils import io as jio
from porotpu_torch.fem import meshio
from porotpu_torch.fem.mesh import generate_cube, generate_square
from porotpu_torch.models import benchmarks
from porotpu_torch.ops.sparse import ELL
from porotpu_torch.tools import bench
from porotpu_torch.utils import cache, io
from torch_k1_cases import import_checks, one_blas_thread  # noqa: F401

torch.set_num_threads(1)


def _swelling(path=None, **over):
    if path is not None:
        over["solver cache path"] = str(path)
    return benchmarks.swelling(3, overrides=over, device="cpu")


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """swelling N=3 at the defaults (f64), built with a solver cache path and
    solved; the cache file it wrote."""
    path = tmp_path_factory.mktemp("cache") / "swelling.pkl"
    p = _swelling(path)
    p.create_solver()
    p.first_timestep = False
    p.cache_writer.join(timeout=60)
    p.solve()
    return p, path


def test_restore_equals_a_fresh_build(fresh):
    p, path = fresh
    assert os.path.getsize(path) > 0
    q = _swelling()
    assert q.try_load_solver_cache(str(path)) and not q.first_timestep
    assert q.dtype == torch.float64 and q.pc.solve_s.kind == "cg+amg"
    q.solve()
    assert q.iteration_log == p.iteration_log
    assert torch.equal(q.sol, p.sol)


def test_restore_applies_inner_iters(fresh):
    _, path = fresh
    q = benchmarks.swelling(3, overrides={"inner iters": 3}, device="cpu")
    assert q.try_load_solver_cache(str(path))
    assert q.pc.solve_s.iters == 3 and q.pc.solve_fp.solve_f.iters == 3
    q.solve()
    r = benchmarks.swelling(3, overrides={"inner iters": 3}, device="cpu")
    r.solve()
    assert r.pc.solve_s.iters == 3
    assert q.iteration_log == r.iteration_log
    assert torch.equal(q.sol, r.sol)


@pytest.mark.parametrize(
    "kind", ["garbage", "stale_schema", "truncated", "wrong_tree", "old_ell_layout"]
)
def test_unusable_cache_misses_and_rebuilds(kind, fresh, tmp_path):
    p, good = fresh
    path = tmp_path / "bad.pkl"
    if kind == "garbage":
        path.write_bytes(b"not a pickle at all")
    elif kind == "stale_schema":
        path.write_bytes(pickle.dumps({"schema": "ancient", "tree": {}}))
    elif kind == "truncated":
        blob = good.read_bytes()
        path.write_bytes(blob[: len(blob) // 2])
    elif kind == "old_ell_layout":
        # the schema "torch-1" wrote ELL without dataT / colsT
        old = ELL.from_csr(sp.random(12, 9, density=0.3, random_state=0, format="csr"))
        del old._buffers["dataT"], old._buffers["colsT"]
        tree = dict(cache.load(str(good)), old_ell=old)
        path.write_bytes(pickle.dumps({"schema": "torch-1", "tree": tree}, protocol=4))
    else:
        path.write_bytes(pickle.dumps({"schema": cache.SCHEMA, "tree": {"A_dev": 1}}))
    if kind != "wrong_tree":
        assert cache.load(str(path)) is None
    q = _swelling()
    assert not q.try_load_solver_cache(str(path)) and q.first_timestep
    q.solve()
    assert q.iteration_log == p.iteration_log


def test_bench_path_restores_from_its_cache(tmp_path):
    """bench's build_problem builds and saves on a miss and restores on a
    hit: the same iterations and solution, no host setup the second time."""
    first = bench.build_problem("float32", 2, device="cpu", cache_dir=str(tmp_path))
    first.cache_writer.join(timeout=60)
    path = bench.cache_path("float32", 2, cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    second = bench.build_problem("float32", 2, device="cpu", cache_dir=str(tmp_path))
    assert second.cache_writer is None and second.assembler.A_blocks is None
    first.solve()
    second.solve()
    assert second.iteration_log == first.iteration_log
    assert torch.equal(second.sol, first.sol)


def test_bench_cache_names_are_never_porotpus():
    """porotpu's bench writes .cache/bench_<16 hex>.pkl (bench.py:83); the
    port's names start torch_bench_ and key impl=torch."""
    names = {
        os.path.basename(bench.cache_path(dt, N, pc))
        for dt in ("float32", "float64") for N in (2, 13) for pc in (None, "float32")
    }
    assert len(names) == 6
    assert all(re.fullmatch(r"torch_bench_[0-9a-f]{16}\.pkl", n) for n in names)
    assert not any(re.fullmatch(r"bench_[0-9a-f]{16}\.pkl", n) for n in names)
    assert os.path.dirname(bench.cache_path("float32", 13)) == ".cache"


def test_restore_imports_neither_jax_nor_porotpu():
    got = import_checks()["cache_restore"]
    assert got["restored"] and got["iterations"] == got["fresh_iterations"]
    assert got["foreign"] == ["jax"], got["foreign"]


# -- the writers ---------------------------------------------------------------

MESHES = {2: (generate_square, jgenerate_square), 3: (generate_cube, jgenerate_cube)}


def _fields(mesh, seed):
    """Fields as solution_fields gives them (vertex values), and a raw
    node-interleaved vector longer than the vertices (a P2 field)."""
    rng = np.random.default_rng(seed)
    nv, dim = mesh.num_vertices, mesh.dim
    return {
        "displacement": rng.normal(size=(nv, dim)),
        "fluid velocity": rng.normal(size=(nv, dim)),
        "pressure": rng.normal(size=nv),
        "raw p2": rng.normal(size=dim * (nv + 7)),
    }


def _same_text(a, b):
    """Two text files with the same structure: equal tokens, and numbers
    within 1e-12 relative."""
    ta, tb = re.split(r'([\s"<>=/]+)', open(a).read()), re.split(r'([\s"<>=/]+)', open(b).read())
    assert len(ta) == len(tb), (a, b)
    for x, y in zip(ta, tb):
        if x == y:
            continue
        fx, fy = float(x), float(y)
        assert abs(fx - fy) <= 1e-12 * max(abs(fx), abs(fy)), (a, x, y)


@pytest.mark.parametrize("dim", [2, 3])
def test_vtu_writer_matches_porotpus(dim, tmp_path):
    mesh = MESHES[dim][0](3, 2.0)[0]
    jmesh = MESHES[dim][1](3, 2.0)[0]
    (tmp_path / "port").mkdir()
    (tmp_path / "porotpu").mkdir()
    w = io.TimeSeriesWriter(str(tmp_path / "port" / "run"), mesh)
    jw = jio.TimeSeriesWriter(str(tmp_path / "porotpu" / "run"), jmesh)
    for step, t in enumerate((0.0, 0.1)):
        w.write(t, _fields(mesh, step))
        jw.write(t, _fields(jmesh, step))
    files = sorted(os.listdir(tmp_path / "porotpu"))
    assert files == ["run.pvd", "run_000000.vtu", "run_000001.vtu"]
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        _same_text(tmp_path / "port" / f, tmp_path / "porotpu" / f)


@pytest.mark.parametrize("dim", [2, 3])
def test_xdmf_writer_matches_porotpus(dim, tmp_path):
    import h5py

    mesh = MESHES[dim][0](3, 2.0)[0]
    jmesh = MESHES[dim][1](3, 2.0)[0]
    (tmp_path / "port").mkdir()
    (tmp_path / "porotpu").mkdir()
    w = io.XDMFWriter(str(tmp_path / "port" / "run"), mesh)
    jw = jio.XDMFWriter(str(tmp_path / "porotpu" / "run"), jmesh)
    for step, t in enumerate((0.0, 0.1)):
        w.write(t, _fields(mesh, step))
        jw.write(t, _fields(jmesh, step))
    w.close()
    jw.close()
    _same_text(tmp_path / "port" / "run.xdmf", tmp_path / "porotpu" / "run.xdmf")

    def datasets(path):
        out = {}
        with h5py.File(path) as f:
            f.visititems(lambda k, v: out.update({k: v[...]}) if isinstance(v, h5py.Dataset)
                         else None)
        return out

    got, want = datasets(tmp_path / "port" / "run.h5"), datasets(tmp_path / "porotpu" / "run.h5")
    assert sorted(got) == sorted(want) and "step_000001/fluid_velocity" in want
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0, err_msg=k)


# -- mesh files ----------------------------------------------------------------


def _tags(mesh, markers):
    return {tuple(sorted(f)): int(t) for f, t in zip(mesh.boundary_facets, markers.tags)}


@pytest.mark.parametrize("writer", ["port", "porotpu"])
@pytest.mark.parametrize("reader", ["port", "porotpu"])
def test_mesh_files_cross_between_packages(writer, reader, tmp_path):
    """save_mesh_xdmf of one package, load_mesh_xdmf of the other (or the
    same): vertices and cells equal, boundary tags equal by facet."""
    gen = {"port": generate_square, "porotpu": jgenerate_square}[writer]
    mesh, markers, *_ = gen(4, 2.0)
    base = str(tmp_path / "sq")
    {"port": meshio, "porotpu": jmeshio}[writer].save_mesh_xdmf(base, mesh, markers)
    m2, mk2 = {"port": meshio, "porotpu": jmeshio}[reader].load_mesh_xdmf(base)
    assert type(m2).__module__.startswith("porotpu_torch." if reader == "port" else "porotpu.")
    np.testing.assert_array_equal(m2.vertices, mesh.vertices)
    np.testing.assert_array_equal(m2.cells, mesh.cells)
    assert _tags(m2, mk2) == _tags(mesh, markers)


def test_prolate_geometry_loader(tmp_path):
    mesh, markers, *_ = generate_cube(2, 1.0)
    d = tmp_path / "meshes"
    d.mkdir()
    meshio.save_mesh_xdmf(str(d / "heart"), mesh, markers)
    m2, mk2, ENDO, EPI, BASE, NONE = meshio.prolateGeometry("heart", meshes_dir=str(d))
    assert (ENDO, EPI, BASE, NONE) == jmeshio.prolateGeometry("heart", meshes_dir=str(d))[2:]
    np.testing.assert_allclose(m2.vertices, mesh.vertices * 1e-3, rtol=1e-15)
    assert _tags(m2, mk2) == _tags(mesh, markers)


def test_checkpoint_round_trip(fresh, tmp_path):
    """save_checkpoint then load_checkpoint at the problem's dtype and
    device: porotpu's npz keys, the padded history fields, the time."""
    p, _ = fresh
    path = str(tmp_path / "state.npz")
    io.save_checkpoint(path, p, p.t)
    with np.load(path) as d:
        assert sorted(d.files) == ["p_nm1", "t", "uf_nm1", "us_nm1", "us_nm2"]
        assert d["us_nm1"].shape == (p.ns_p,) and d["p_nm1"].shape == (p.np_p,)
    q = _swelling()
    assert io.load_checkpoint(path, q) == p.t == q.t
    for key in ("us_nm1", "us_nm2", "uf_nm1", "p_nm1"):
        got = getattr(q, key)
        assert got.dtype == q.dtype and got.device == q.device
        assert torch.equal(got, getattr(p, key)), key

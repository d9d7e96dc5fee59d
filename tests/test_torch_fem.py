"""The port's own host modules against porotpu's, and the port's import and
device rules.

``porotpu_torch.fem`` and ``porotpu_torch.models.{forms,loads,abstract}``
are copies of porotpu's.  On swelling-3d N=2 (P2/P2/P1) they must give
the same mesh, dofmaps, BC dofs and load vector (equal arrays) and the
same assembled CSR blocks: equal index arrays and data to 1e-14 relative
(the copies run the same numpy code, so any difference is a fault of the
copy).  The entry points run on the card unless asked for the CPU; that a
solve loads no module of porotpu is checked by
tests/test_torch_slice.py:test_port_runs_without_jax.
"""

import inspect

import numpy as np
import pytest
import torch

from porotpu.fem.bcs import bc_dofs_values as jbc_dofs_values
from porotpu.fem.dofmap import FunctionSpace as JFunctionSpace
from porotpu.fem.dofmap import vertex_embedding as jvertex_embedding
from porotpu.fem.mesh import generate_cube as jgenerate_cube
from porotpu.models import benchmarks as jbench
from porotpu_torch.fem.bcs import bc_dofs_values
from porotpu_torch.fem.dofmap import FunctionSpace, vertex_embedding
from porotpu_torch.fem.mesh import generate_cube
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d
from porotpu_torch.models.poromechanics import Poromechanics
from torch_k1_cases import one_blas_thread  # noqa: F401

F64 = dict(BENCH_OVERRIDES, dtype="float64")


@pytest.fixture(scope="module")
def problems():
    jp = jbench.swelling_3d(2, overrides=F64)
    p = swelling_3d(2, overrides=F64, device="cpu")
    jp.assembler.assemble()
    p.assembler.assemble()
    return jp, p


def test_mesh_dofmap_bcs_loads_match_porotpu(problems):
    jp, p = problems
    np.testing.assert_array_equal(p.mesh.vertices, jp.mesh.vertices)
    np.testing.assert_array_equal(p.mesh.cells, jp.mesh.cells)
    np.testing.assert_array_equal(p.mesh.boundary_facets, jp.mesh.boundary_facets)
    np.testing.assert_array_equal(p.mesh.boundary_facet_normals(), jp.mesh.boundary_facet_normals())
    np.testing.assert_array_equal(p.markers.tags, jp.markers.tags)
    for f in ("s", "f", "p"):
        sp_, jsp = p.W.space(f), jp.W.space(f)
        for attr in ("node_coords", "cell_nodes", "cell_dofs", "vert_node"):
            np.testing.assert_array_equal(getattr(sp_, attr), getattr(jsp, attr))
        assert p.W.offset(f) == jp.W.offset(f)
    for f in ("s", "f"):
        np.testing.assert_array_equal(
            vertex_embedding(p.W.space("p"), p.W.space(f), p.np_p, p.ns_p),
            jvertex_embedding(jp.W.space("p"), jp.W.space(f), jp.np_p, jp.ns_p),
        )
    for got, want in zip(bc_dofs_values(p.bcs), jbc_dofs_values(jp.bcs)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        p.assembler.get_load_vector(0.1), jp.assembler.get_load_vector(0.1)
    )


@pytest.mark.parametrize("which", ["A_blocks", "P_blocks"])
def test_assembled_blocks_match_porotpu_csr(which, problems):
    jp, p = problems
    blocks, jblocks = getattr(p.assembler, which), getattr(jp.assembler, which)
    assert sorted(blocks) == sorted(jblocks)
    for key, M in blocks.items():
        J = jblocks[key]
        assert M.shape == J.shape, key
        np.testing.assert_array_equal(M.indptr, J.indptr)
        np.testing.assert_array_equal(M.indices, J.indices)
        scale = np.abs(J.data).max()
        np.testing.assert_allclose(M.data, J.data, rtol=1e-14, atol=1e-14 * scale)


def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (swelling_3d, Poromechanics.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        swelling_3d(2, overrides=F64)


def test_face_lookup_checks_its_hits():
    """P3 on the N=3 cube: the facet lookups and boundary nodes match
    porotpu's, and a vertex triple that is no face raises (porotpu's copy
    returns an arbitrary face id for it)."""
    V = FunctionSpace(generate_cube(3, 1.0)[0], 3, vector=True)
    J = JFunctionSpace(jgenerate_cube(3, 1.0)[0], 3, vector=True)
    facets = np.sort(V.mesh.boundary_facets, axis=1)
    np.testing.assert_array_equal(V._face_lookup(facets), J._face_lookup(facets))
    np.testing.assert_array_equal(V.boundary_nodes(), J.boundary_nodes())
    nv = V.mesh.num_vertices
    inner = np.array([[0, nv // 2, nv - 1]])  # between two faces' keys
    assert not (V.faces == inner).all(axis=1).any()
    for triple in (inner, np.array([[nv, nv, nv]])):  # the second beyond every key
        with pytest.raises(ValueError, match="no face"):
            V._face_lookup(triple)

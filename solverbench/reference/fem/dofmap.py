# Frozen copy of porotpu_torch/fem/dofmap.py, the benchmark reference's own: later changes to the port do not reach it.
"""Dof numbering for P1/P2 Lagrange spaces and the field-major mixed space.

Replaces DOLFIN dofmaps + lib/IndexSet.py of the reference.  A key TPU-first
design decision (SURVEY.md §7.1): the mixed space uses **field-major global
numbering** ``[solid | fluid | pressure]`` so the reference's index sets
``is_s/is_f/is_p/is_fp`` (lib/IndexSet.py:57-60) become contiguous slices and
per-field blocks are assembled directly — eliminating the numba membership
kernel (lib/IndexSet.py:10-26) and PETSc createSubMatrix gathers
(lib/Preconditioner.py:61-68) entirely.

Vector dofs are node-interleaved within a field: node n, component c ->
local dof n*dim + c.  This yields dense (dim x dim) node blocks, the unit
of the block-ELL device format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .elements import edge_list, num_basis
from .mesh import Mesh


def _build_edges(mesh: Mesh):
    """Unique mesh edges and per-cell edge ids; also facet->edge lookup."""
    el = edge_list(mesh.dim)
    e = np.sort(mesh.cells[:, el].reshape(-1, 2), axis=1)
    uniq, inv = np.unique(e, axis=0, return_inverse=True)
    cell_edges = inv.reshape(mesh.num_cells, el.shape[0])
    return uniq, cell_edges


def _lattice_order(coords: np.ndarray, scale: float) -> np.ndarray:
    """Lexicographic (z, y, x) ordering of nodes on a quantized lattice.

    TPU-first design decision: banded (DIA) SpMV needs a spatially
    coherent numbering — on structured meshes the lex order makes every
    FE matrix multi-diagonal with a bounded offset set (ops/dia.py), e.g.
    233 diagonals instead of 44,771 for the swelling-3d P2 solid block.
    Returns ``order``: new position -> old node id.
    """
    q = max(scale, 1e-300)
    key = np.round(coords / q).astype(np.int64)
    cols = tuple(key[:, d] for d in range(coords.shape[1]))
    return np.lexsort(cols)  # last key is primary: sorts z, then y, then x


class FunctionSpace:
    """Scalar or vector continuous Lagrange space on a Mesh.

    Nodes are numbered lattice-lexicographically (see _lattice_order); the
    maps ``vert_node`` (mesh vertex -> space node) and ``edge_node`` (P2
    edge -> space node) translate mesh entities to node ids.
    """

    def __init__(self, mesh: Mesh, degree: int, vector: bool = False):
        self.mesh = mesh
        self.degree = degree
        self.vector = vector
        self.dim = mesh.dim  # geometric = value dimension for vector spaces
        nv = mesh.num_vertices

        if degree == 1:
            self.num_nodes = nv
            cell_nodes = mesh.cells.copy()
            node_coords = mesh.vertices.copy()
            self.edges = None
            self.cell_edges = None
        elif degree == 2:
            edges, cell_edges = _build_edges(mesh)
            self.edges = edges
            self.cell_edges = cell_edges
            self.num_nodes = nv + edges.shape[0]
            cell_nodes = np.concatenate(
                [mesh.cells, nv + cell_edges], axis=1
            ).astype(np.int64)
            mid = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
            node_coords = np.concatenate([mesh.vertices, mid], axis=0)
        elif degree == 3:
            # two nodes per edge (global order: nearer the SMALLER vertex
            # first — edges are sorted pairs) + one bubble per face (2D:
            # cell interior; 3D: triangular facet), matching the local
            # element ordering in fem/elements.py (--fe-solid 3 support,
            # reference lib/Parser.py:23-24)
            edges, cell_edges = _build_edges(mesh)
            self.edges = edges
            self.cell_edges = cell_edges
            ne = edges.shape[0]
            va, vb = mesh.vertices[edges[:, 0]], mesh.vertices[edges[:, 1]]
            en = np.stack(
                [(2.0 * va + vb) / 3.0, (va + 2.0 * vb) / 3.0], axis=1
            ).reshape(-1, mesh.dim)  # interleaved: [e0n0, e0n1, e1n0, ...]
            if mesh.dim == 2:
                faces = None
                cell_faces = np.arange(mesh.num_cells)[:, None]
                fc = mesh.vertices[mesh.cells].mean(axis=1)
            else:
                from .elements import TET_FACETS

                tri = np.sort(
                    mesh.cells[:, TET_FACETS].reshape(-1, 3), axis=1
                )
                faces, finv = np.unique(tri, axis=0, return_inverse=True)
                cell_faces = finv.reshape(mesh.num_cells, 4)
                fc = mesh.vertices[faces].mean(axis=1)
            self.faces = faces
            self.cell_faces = cell_faces
            nfc = fc.shape[0]
            self.num_nodes = nv + 2 * ne + nfc
            # per-cell edge nodes with LOCAL orientation (nearer local-j
            # first): flip when the local edge runs large->small vertex
            le = edge_list(mesh.dim)
            vj = mesh.cells[:, le[:, 0]]
            vk = mesh.cells[:, le[:, 1]]
            flip = (vj > vk).astype(np.int64)  # (nc, nle)
            first = nv + 2 * cell_edges + flip
            second = nv + 2 * cell_edges + (1 - flip)
            enodes = np.stack([first, second], axis=2).reshape(
                mesh.num_cells, -1
            )
            cell_nodes = np.concatenate(
                [mesh.cells, enodes, nv + 2 * ne + cell_faces], axis=1
            ).astype(np.int64)
            node_coords = np.concatenate([mesh.vertices, en, fc], axis=0)
        else:
            raise ValueError("degree must be 1, 2 or 3")

        # lattice-lexicographic renumbering (Pk spacing is hmin/k; the
        # quantum is kept at hmin/4 for P1/P2 — the established layout —
        # and hmin/6 for P3's third-point nodes)
        order = _lattice_order(
            node_coords, mesh.hmin() / (4.0 if degree <= 2 else 6.0)
        )
        rank = np.empty(self.num_nodes, dtype=np.int64)
        rank[order] = np.arange(self.num_nodes)
        self.node_coords = np.ascontiguousarray(node_coords[order])
        self.cell_nodes = rank[cell_nodes]
        self.vert_node = rank[:nv]  # mesh vertex id -> space node id
        if degree == 2:
            self.edge_node = rank[nv:]
        elif degree == 3:
            ne = self.edges.shape[0]
            # (ne, 2): per edge [node nearer smaller vertex, nearer larger]
            self.edge_node = rank[nv : nv + 2 * ne].reshape(ne, 2)
            self.face_node = rank[nv + 2 * ne :]
        else:
            self.edge_node = None

        self.ncomp = self.dim if vector else 1
        self.num_dofs = self.num_nodes * self.ncomp
        self.nb_scalar = num_basis(mesh.dim, degree)

        if vector:
            # (nc, nb_scalar*dim): node-interleaved
            cn = self.cell_nodes
            cd = (cn[:, :, None] * self.ncomp + np.arange(self.ncomp)[None, None, :])
            self.cell_dofs = cd.reshape(mesh.num_cells, -1).astype(np.int64)
        else:
            self.cell_dofs = self.cell_nodes

        self._bnodes = None  # lazy: nodes on the boundary

    # -- boundary queries ---------------------------------------------------

    def facet_nodes(self, facet_ids: np.ndarray) -> np.ndarray:
        """All space nodes lying on the given boundary facets (unique)."""
        mesh = self.mesh
        f = mesh.boundary_facets[facet_ids]
        nodes = [self.vert_node[f.ravel()]]
        if self.degree >= 2:
            # edge nodes of the facet's edges (1 midpoint for P2, both
            # third-points for P3 — edge_node is (ne,) resp. (ne, 2))
            if mesh.dim == 2:
                fe = np.sort(f, axis=1)  # facet IS an edge
                eids = self._edge_lookup(fe)
                nodes.append(self.edge_node[eids].ravel())
            else:
                # 3 edges per triangular facet
                pairs = np.concatenate(
                    [f[:, [0, 1]], f[:, [0, 2]], f[:, [1, 2]]], axis=0
                )
                eids = self._edge_lookup(np.sort(pairs, axis=1))
                nodes.append(self.edge_node[eids].ravel())
        if self.degree == 3 and mesh.dim == 3:
            nodes.append(self.face_node[self._face_lookup(np.sort(f, axis=1))])
        return np.unique(np.concatenate(nodes))

    def _face_lookup(self, triples: np.ndarray) -> np.ndarray:
        """Map sorted vertex triples to face ids (requires degree 3, 3D).
        Raises ValueError for a triple that is not a face."""
        faces = self.faces
        nvv = self.mesh.num_vertices + 1
        key_all = (
            faces[:, 0].astype(np.int64) * nvv + faces[:, 1]
        ) * nvv + faces[:, 2]
        key = (
            triples[:, 0].astype(np.int64) * nvv + triples[:, 1]
        ) * nvv + triples[:, 2]
        order = np.argsort(key_all)
        sorted_keys = key_all[order]
        pos = np.searchsorted(sorted_keys, key)
        hit = pos < sorted_keys.size
        hit[hit] = sorted_keys[pos[hit]] == key[hit]
        if not hit.all():
            raise ValueError(
                f"face lookup: {int((~hit).sum())} vertex triples are no face, "
                f"e.g. {triples[~hit][0]}"
            )
        return order[pos]

    def _edge_lookup(self, pairs: np.ndarray) -> np.ndarray:
        """Map sorted vertex pairs to edge ids (requires degree 2)."""
        edges = self.edges
        # encode pair as single integer key for searchsorted
        nvv = self.mesh.num_vertices + 1
        key_all = edges[:, 0].astype(np.int64) * nvv + edges[:, 1]
        order = np.argsort(key_all)
        key_q = pairs[:, 0].astype(np.int64) * nvv + pairs[:, 1]
        pos = np.searchsorted(key_all[order], key_q)
        eids = order[pos]
        assert np.all(key_all[eids] == key_q), "edge lookup failed"
        return eids

    def boundary_nodes(self) -> np.ndarray:
        if self._bnodes is None:
            nf = self.mesh.boundary_facets.shape[0]
            self._bnodes = self.facet_nodes(np.arange(nf))
        return self._bnodes

    def nodes_to_dofs(self, nodes: np.ndarray, component=None) -> np.ndarray:
        """Global dofs (within this space) of the given nodes.

        ``component``: None -> all components; int -> that component only.
        """
        if not self.vector:
            return np.asarray(nodes, dtype=np.int64)
        nodes = np.asarray(nodes, dtype=np.int64)
        if component is None:
            return (
                nodes[:, None] * self.ncomp + np.arange(self.ncomp)[None, :]
            ).ravel()
        return nodes * self.ncomp + int(component)

    def dof_coords(self) -> np.ndarray:
        """(num_dofs, dim) coordinates of each dof's node."""
        if not self.vector:
            return self.node_coords
        return np.repeat(self.node_coords, self.ncomp, axis=0)


def vertex_embedding(
    col_space: "FunctionSpace",
    row_space: "FunctionSpace",
    n_cols_pad: int | None = None,
    n_rows_pad: int | None = None,
) -> np.ndarray | None:
    """Injective map of a scalar P1 column space's dofs into a row space's
    dof index range, enabling banded (DIA) storage of cross-space blocks
    (ops/dia.py col_emb): P1 node q -> dof of the row-space node sitting on
    the same mesh vertex (component 0 for vector row spaces).

    Pad columns (field segments are padded to ``pad multiple``,
    models/poromechanics.py) are mapped to unused row slots so the
    embedding stays injective over the full padded width.  Returns None
    when no such embedding exists (col space not scalar P1, different
    meshes, or not enough free row slots).
    """
    if col_space.degree != 1 or col_space.vector:
        return None
    if col_space.mesh is not row_space.mesh:
        return None
    nv = col_space.mesh.num_vertices
    vertex_of = np.empty(nv, dtype=np.int64)
    vertex_of[col_space.vert_node] = np.arange(nv)
    emb = row_space.vert_node[vertex_of] * row_space.ncomp
    n_cols_pad = n_cols_pad if n_cols_pad is not None else nv
    n_rows_pad = n_rows_pad if n_rows_pad is not None else row_space.num_dofs
    npad = n_cols_pad - nv
    if npad > 0:
        used = np.zeros(n_rows_pad, dtype=bool)
        used[emb] = True
        free = np.nonzero(~used)[0]
        if free.size < npad:
            return None
        emb = np.concatenate([emb, free[:npad]])
    return emb


@dataclass
class FieldSlice:
    name: str
    offset: int
    size: int

    @property
    def slice(self) -> slice:
        return slice(self.offset, self.offset + self.size)


class MixedSpace:
    """Field-major composition of FunctionSpaces: [field0 | field1 | ...].

    Provides the role of the reference's mixed FE space + IndexSet
    (lib/Poromechanics.py:14-18, lib/IndexSet.py:30-61): per-field dof
    ranges are contiguous slices.
    """

    def __init__(self, spaces: dict):
        """spaces: ordered {name: FunctionSpace}."""
        self.spaces = dict(spaces)
        self.fields = []
        off = 0
        for name, sp in self.spaces.items():
            self.fields.append(FieldSlice(name, off, sp.num_dofs))
            off += sp.num_dofs
        self.num_dofs = off
        self._by_name = {f.name: f for f in self.fields}

    def field(self, name: str) -> FieldSlice:
        return self._by_name[name]

    def space(self, name: str) -> FunctionSpace:
        return self.spaces[name]

    def offset(self, name: str) -> int:
        return self._by_name[name].offset

    def get_dimensions(self):
        """(ns, nf, np) — reference lib/IndexSet.py:63-64 parity."""
        return tuple(f.size for f in self.fields)

    def global_dofs(self, name: str, local_dofs: np.ndarray) -> np.ndarray:
        return np.asarray(local_dofs, dtype=np.int64) + self.offset(name)

    def split(self, x):
        """Split a monolithic vector into per-field views."""
        return {f.name: x[f.slice] for f in self.fields}

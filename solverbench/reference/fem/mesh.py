# Frozen copy of porotpu_torch/fem/mesh.py, the benchmark reference's own: later changes to the port do not reach it.
"""Structured simplicial meshes with boundary markers and refinement.

Replaces DOLFIN's mesh stack + lib/MeshCreation.py of the reference:
- generate_square   (reference lib/MeshCreation.py:11-50)
- generate_footing_square (53-104): two rounds of local refinement of the
  top-center region
- generate_rectangle (107-143)
- generate_cube      (169-215)
- generate_boundary_measure (218-223)

Marker numbering matches the reference exactly:
  2D: LEFT, RIGHT, TOP, BOTTOM = 1, 2, 3, 4 ; NONE = 99
  3D: XP, XM, YP, YM, ZP, ZM   = 1, 2, 3, 4, 5, 6

Local refinement uses conforming longest-edge (Rivara) bisection; two
bisection passes per marked cell approximate DOLFIN's plaza refine of
marked cells.  Uniform refinement is red (tri -> 4, tet -> 8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NONE = 99
LEFT, RIGHT, TOP, BOTTOM = 1, 2, 3, 4
XP, XM, YP, YM, ZP, ZM = 1, 2, 3, 4, 5, 6


@dataclass
class Mesh:
    """Simplicial mesh: triangles (dim=2) or tetrahedra (dim=3)."""

    dim: int
    vertices: np.ndarray  # (nv, dim) float64
    cells: np.ndarray  # (nc, dim+1) int64

    # boundary facets, computed lazily
    _bfacets: np.ndarray | None = field(default=None, repr=False)
    _bfacet_cells: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def _compute_boundary(self):
        """Find facets that appear in exactly one cell (boundary) + owner cell."""
        d = self.dim
        cells = self.cells
        if d == 2:
            locf = np.array([[1, 2], [0, 2], [0, 1]])
        else:
            locf = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
        nf_per = locf.shape[0]
        facets = cells[:, locf].reshape(-1, d)  # (nc*nf_per, d)
        owner = np.repeat(np.arange(cells.shape[0]), nf_per)
        key = np.sort(facets, axis=1)
        # lexicographic unique with counts
        order = np.lexsort(key.T[::-1])
        ks = key[order]
        newgrp = np.ones(len(ks), dtype=bool)
        newgrp[1:] = np.any(ks[1:] != ks[:-1], axis=1)
        grp_id = np.cumsum(newgrp) - 1
        counts = np.bincount(grp_id)
        single = counts[grp_id] == 1
        sel = order[single]
        self._bfacets = facets[sel]
        self._bfacet_cells = owner[sel]

    @property
    def boundary_facets(self) -> np.ndarray:
        if self._bfacets is None:
            self._compute_boundary()
        return self._bfacets

    @property
    def boundary_facet_cells(self) -> np.ndarray:
        if self._bfacets is None:
            self._compute_boundary()
        return self._bfacet_cells

    def boundary_facet_normals(self) -> np.ndarray:
        """Outward unit normals, one per boundary facet."""
        f = self.boundary_facets
        v = self.vertices
        if self.dim == 2:
            t = v[f[:, 1]] - v[f[:, 0]]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        else:
            e1 = v[f[:, 1]] - v[f[:, 0]]
            e2 = v[f[:, 2]] - v[f[:, 0]]
            n = np.cross(e1, e2)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        # orient outward: away from owner-cell centroid
        cent_c = v[self.cells[self.boundary_facet_cells]].mean(axis=1)
        cent_f = v[f].mean(axis=1)
        flip = np.einsum("ij,ij->i", n, cent_f - cent_c) < 0
        n[flip] *= -1.0
        return n

    def hmin(self) -> float:
        """Minimum cell diameter (min edge length), as in DOLFIN mesh.hmin()."""
        from .elements import edge_list

        e = edge_list(self.dim)
        edges = self.cells[:, e]  # (nc, ne, 2)
        d = self.vertices[edges[..., 1]] - self.vertices[edges[..., 0]]
        return float(np.sqrt((d**2).sum(-1)).min())


# ---------------------------------------------------------------------------
# structured generation
# ---------------------------------------------------------------------------


def _structured_square(nx: int, ny: int, x0=0.0, y0=0.0, x1=1.0, y1=1.0) -> Mesh:
    """UnitSquare-style mesh: each grid quad split by the 'right' diagonal."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = i.ravel()
    j = j.ravel()
    v00 = vid(i, j)
    v10 = vid(i + 1, j)
    v01 = vid(i, j + 1)
    v11 = vid(i + 1, j + 1)
    # 'right' diagonal from (i,j) to (i+1,j+1)
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0).astype(np.int64)
    return Mesh(2, verts, cells)


def _structured_cube(n: int, length=1.0) -> Mesh:
    """UnitCube-style mesh: each grid cube split into 6 tets (Kuhn)."""
    xs = np.linspace(0.0, length, n + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    m = n + 1

    def vid(i, j, k):
        return (i * m + j) * m + k

    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    c = {}
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c[(di, dj, dk)] = vid(i + di, j + dj, k + dk)
    # Kuhn triangulation: 6 tets around the main diagonal (0,0,0)-(1,1,1)
    paths = [
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],
    ]
    tets = []
    for p in paths:
        tets.append(np.stack([c[p[0]], c[p[1]], c[p[2]], c[p[3]]], axis=1))
    cells = np.concatenate(tets, axis=0).astype(np.int64)
    return Mesh(3, verts, cells)


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------


def _unique_edges(cells: np.ndarray, dim: int):
    from .elements import edge_list

    el = edge_list(dim)
    e = np.sort(cells[:, el].reshape(-1, 2), axis=1)
    uniq, inv = np.unique(e, axis=0, return_inverse=True)
    return uniq, inv.reshape(cells.shape[0], el.shape[0])


def refine_uniform(mesh: Mesh) -> Mesh:
    """Red refinement: triangle -> 4 children, tet -> 8 children."""
    cells = mesh.cells
    verts = mesh.vertices
    uniq, cell_edges = _unique_edges(cells, mesh.dim)
    mid = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
    newv = np.concatenate([verts, mid], axis=0)
    off = verts.shape[0]
    if mesh.dim == 2:
        v0, v1, v2 = cells.T
        # edge order (1,2),(0,2),(0,1)
        m12 = off + cell_edges[:, 0]
        m02 = off + cell_edges[:, 1]
        m01 = off + cell_edges[:, 2]
        child = np.concatenate(
            [
                np.stack([v0, m01, m02], 1),
                np.stack([m01, v1, m12], 1),
                np.stack([m02, m12, v2], 1),
                np.stack([m01, m12, m02], 1),
            ],
            axis=0,
        )
        return Mesh(2, newv, child.astype(np.int64))
    # tets: 4 corner tets + octahedron split along diagonal m02-m13
    v0, v1, v2, v3 = cells.T
    # edges (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
    m01 = off + cell_edges[:, 0]
    m02 = off + cell_edges[:, 1]
    m03 = off + cell_edges[:, 2]
    m12 = off + cell_edges[:, 3]
    m13 = off + cell_edges[:, 4]
    m23 = off + cell_edges[:, 5]
    child = np.concatenate(
        [
            np.stack([v0, m01, m02, m03], 1),
            np.stack([m01, v1, m12, m13], 1),
            np.stack([m02, m12, v2, m23], 1),
            np.stack([m03, m13, m23, v3], 1),
            # octahedron (m01, m02, m03, m12, m13, m23) split by diagonal m02-m13
            np.stack([m01, m02, m03, m13], 1),
            np.stack([m01, m02, m12, m13], 1),
            np.stack([m02, m03, m13, m23], 1),
            np.stack([m02, m12, m13, m23], 1),
        ],
        axis=0,
    )
    return Mesh(3, newv, child.astype(np.int64))


def refine_marked(mesh: Mesh, marked: np.ndarray, passes: int = 2) -> Mesh:
    """Conforming local refinement of marked cells (Rivara longest-edge
    bisection, dimension-generic: triangles AND tetrahedra).

    ``marked``: boolean array over cells.  Each pass bisects every marked
    simplex by its longest edge, recursively bisecting neighbors to keep
    the mesh conforming.  Two passes subdivide a marked cell into ~4
    children, matching the granularity of DOLFIN refine(mesh, markers)
    (reference lib/MeshCreation.py:59-74, which is dimension-generic the
    same way).
    """
    vert_arr = [np.array(v) for v in mesh.vertices]
    cells = [tuple(c) for c in mesh.cells]
    marked_now = set(np.nonzero(marked)[0].tolist())

    for _ in range(passes):
        verts_np = np.array(vert_arr)
        cells_np = np.array(cells, dtype=np.int64)
        new_cells, vert_arr = _bisect_pass(verts_np, cells_np, marked_now)
        cells = new_cells
        # children of previously marked cells stay marked across passes:
        # _bisect_pass returns marked child indices via closure
        marked_now = _bisect_pass.last_marked_children

    return Mesh(mesh.dim, np.array(vert_arr), np.array(cells, dtype=np.int64))


def _bisect_pass(verts: np.ndarray, cells: np.ndarray, marked: set):
    """One Rivara longest-edge bisection pass (any simplex dimension).

    A simplex is bisected by replacing each endpoint of its longest edge
    with the edge midpoint (the generic child rule — in 2D this is the
    classic triangle bisection, in 3D the tetrahedral longest-edge
    bisection).  Returns (cells, verts).
    """
    nv = verts.shape[0]
    vert_list = [verts[i] for i in range(nv)]
    midpoint = {}  # sorted edge -> new vertex id

    def get_mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in midpoint:
            vert_list.append(0.5 * (vert_list[a] + vert_list[b]))
            midpoint[key] = len(vert_list) - 1
        return midpoint[key]

    def cell_edges(cell):
        return [
            (min(cell[i], cell[j]), max(cell[i], cell[j]))
            for i in range(len(cell))
            for j in range(i + 1, len(cell))
        ]

    def longest_edge(cell):
        # deterministic tie-break by vertex ids
        cand = [
            (-np.sum((vert_list[e[0]] - vert_list[e[1]]) ** 2), e)
            for e in cell_edges(cell)
        ]
        cand.sort(key=lambda t: (t[0], t[1]))
        return cand[0][1]

    simps = [tuple(c) for c in cells]
    from_marked = [i in marked for i in range(len(simps))]
    alive = {i: simps[i] for i in range(len(simps))}
    origin = {i: from_marked[i] for i in range(len(simps))}
    next_id = len(simps)

    # First split all marked cells' longest edges (creating midpoints),
    # then resolve non-conformity: any alive cell having a split edge
    # must be bisected by its longest edge (splitting more edges), repeat.
    for i in list(marked):
        get_mid(*longest_edge(alive[i]))

    changed = True
    while changed:
        changed = False
        for i in list(alive.keys()):
            cell = alive[i]
            if not any(e in midpoint for e in cell_edges(cell)):
                continue
            le = longest_edge(cell)
            m = get_mid(*le)
            rest = tuple(v for v in cell if v not in le)
            t1 = rest + (le[0], m)
            t2 = rest + (m, le[1])
            del alive[i]
            for child in (t1, t2):
                alive[next_id] = child
                origin[next_id] = origin[i]
                next_id += 1
            changed = True

    out_cells = []
    marked_children = set()
    for j, (i, cell) in enumerate(sorted(alive.items())):
        out_cells.append(cell)
        if origin[i]:
            marked_children.add(j)
    _bisect_pass.last_marked_children = marked_children
    return out_cells, vert_list


_bisect_pass.last_marked_children = set()


# ---------------------------------------------------------------------------
# boundary markers
# ---------------------------------------------------------------------------


class BoundaryMarkers:
    """Integer marker per boundary facet (DOLFIN MeshFunction equivalent)."""

    def __init__(self, mesh: Mesh, marker_fns: dict):
        """marker_fns: {tag: predicate(x_midpoints (nf,dim)) -> bool array}.

        Later entries override earlier ones (DOLFIN ``mark`` order semantics,
        reference lib/MeshCreation.py:45-48).
        """
        self.mesh = mesh
        f = mesh.boundary_facets
        mid = mesh.vertices[f].mean(axis=1)
        # facet is marked if *all* its vertices satisfy the predicate
        # (DOLFIN SubDomain.inside is evaluated vertex-wise)
        tags = np.zeros(f.shape[0], dtype=np.int64)
        vcoords = mesh.vertices[f]  # (nf, d, dim)
        for tag, fn in marker_fns.items():
            ok = np.ones(f.shape[0], dtype=bool)
            for k in range(f.shape[1]):
                ok &= fn(vcoords[:, k, :])
            tags[ok] = tag
        self.tags = tags
        self.midpoints = mid

    def facets_with(self, tag_list) -> np.ndarray:
        """Boundary-facet indices whose tag is in tag_list."""
        mask = np.isin(self.tags, np.asarray(list(tag_list), dtype=np.int64))
        return np.nonzero(mask)[0]


def _near(a, b, tol=1e-10):
    return np.abs(a - b) < tol * max(1.0, abs(b)) + 1e-14


def _mark_square(mesh: Mesh, length_x: float, length_y: float, x0=0.0, y0=0.0):
    return BoundaryMarkers(
        mesh,
        {
            LEFT: lambda x: _near(x[:, 0], x0),
            RIGHT: lambda x: _near(x[:, 0], x0 + length_x),
            TOP: lambda x: _near(x[:, 1], y0 + length_y),
            BOTTOM: lambda x: _near(x[:, 1], y0),
        },
    )


def generate_square(Nelements: int, length: float, refinements: int = 0):
    """Square mesh with LEFT/RIGHT/TOP/BOTTOM = 1/2/3/4 markers.

    Mirrors reference lib/MeshCreation.py:11-50 (refine then scale).
    """
    mesh = _structured_square(Nelements, Nelements)
    for _ in range(refinements):
        mesh = refine_uniform(mesh)
    mesh.vertices = mesh.vertices * length
    markers = _mark_square(mesh, length, length)
    return mesh, markers, LEFT, RIGHT, TOP, BOTTOM, NONE


def generate_rectangle(x0, y0, x1, y1, nx, ny):
    """Rectangle mesh (reference lib/MeshCreation.py:107-143)."""
    mesh = _structured_square(nx, ny, x0, y0, x1, y1)
    markers = BoundaryMarkers(
        mesh,
        {
            LEFT: lambda x: _near(x[:, 0], x0),
            RIGHT: lambda x: _near(x[:, 0], x1),
            TOP: lambda x: _near(x[:, 1], y1),
            BOTTOM: lambda x: _near(x[:, 1], y0),
        },
    )
    return mesh, markers, LEFT, RIGHT, TOP, BOTTOM, NONE


def generate_footing_square(Nelements: int, length: float, refinements: int = 0):
    """Footing mesh: square + two rounds of local top-center refinement.

    Marked region: cells with min(y) > 2L/3 and L/8 < x < 7L/8
    (reference lib/MeshCreation.py:59-74).
    """
    mesh = _structured_square(Nelements, Nelements)
    mesh.vertices = mesh.vertices * length

    def mark(mesh):
        vc = mesh.vertices[mesh.cells]  # (nc, 3, 2)
        return (
            (vc[:, :, 1].min(axis=1) > 2.0 * length / 3.0)
            & (vc[:, :, 0].min(axis=1) > length / 8.0)
            & (vc[:, :, 0].max(axis=1) < 7.0 * length / 8.0)
        )

    mesh = refine_marked(mesh, mark(mesh), passes=2)
    mesh = refine_marked(mesh, mark(mesh), passes=2)
    for _ in range(refinements):
        mesh = refine_uniform(mesh)
    markers = _mark_square(mesh, length, length)
    return mesh, markers, LEFT, RIGHT, TOP, BOTTOM, NONE


def generate_cube(Nelements: int, length: float, refinements: int = 0):
    """Cube mesh with XP/XM/YP/YM/ZP/ZM = 1..6 markers.

    Mirrors reference lib/MeshCreation.py:169-215.
    """
    mesh = _structured_cube(Nelements)
    for _ in range(refinements):
        mesh = refine_uniform(mesh)
    mesh.vertices = mesh.vertices * length
    markers = BoundaryMarkers(
        mesh,
        {
            XP: lambda x: _near(x[:, 0], length),
            XM: lambda x: _near(x[:, 0], 0.0),
            YP: lambda x: _near(x[:, 1], length),
            YM: lambda x: _near(x[:, 1], 0.0),
            ZP: lambda x: _near(x[:, 2], length),
            ZM: lambda x: _near(x[:, 2], 0.0),
        },
    )
    return mesh, markers, XP, XM, YP, YM, ZP, ZM


class BoundaryMeasure:
    """A set of tagged boundary facets over which surface loads integrate.

    Equivalent of ``sum(ds(i) for i in tags)`` in the reference
    (lib/MeshCreation.py:218-223).
    """

    def __init__(self, mesh: Mesh, markers: BoundaryMarkers, tags_list):
        self.mesh = mesh
        self.markers = markers
        self.tags = list(tags_list)
        self.facet_ids = markers.facets_with(self.tags) if self.tags else np.zeros(0, np.int64)


def generate_boundary_measure(mesh: Mesh, markers: BoundaryMarkers, tags_list, none_tag=NONE):
    return BoundaryMeasure(mesh, markers, tags_list)

# Frozen copy of porotpu_torch/fem/elements.py, the benchmark reference's own: later changes to the port do not reach it.
"""Continuous Lagrange elements P1/P2/P3 on intervals/triangles/tetrahedra.

Replaces DOLFIN's FiniteElement/VectorElement tabulation (reference:
lib/Poromechanics.py:14-18 builds CG degree 2/2/1 spaces; lib/Parser.py:
23-24 exposes --fe-solid for arbitrary displacement degree).  Basis
functions are expressed in barycentric coordinates; geometry is affine so
physical gradients are ``grad_ref @ inv(J)`` with a constant Jacobian per
cell.

Local node ordering:
- vertices first (simplex vertex order);
- P2: one midpoint per edge, in edge_list order;
- P3: TWO nodes per edge in edge_list order — for edge (j, k) the node
  nearer j (lam_j = 2/3) comes first — then the interior/face bubbles:
  one cell bubble in 2D, one per facet (TET_FACETS order) in 3D.
- triangle edges: (1,2), (0,2), (0,1)   [edge i opposite vertex i]
- tet edges:      (0,1), (0,2), (0,3), (1,2), (1,3), (2,3)
"""

from __future__ import annotations

import numpy as np

TRI_EDGES = np.array([[1, 2], [0, 2], [0, 1]])
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
# Facets of a tet: facet i opposite vertex i
TET_FACETS = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]])


INTERVAL_EDGES = np.array([[0, 1]])


def edge_list(dim: int) -> np.ndarray:
    if dim == 1:
        return INTERVAL_EDGES  # facet-chart tabulation of 2D meshes
    return TRI_EDGES if dim == 2 else TET_EDGES


def _bary(points: np.ndarray) -> np.ndarray:
    """Reference coords (nq, dim) -> barycentric (nq, dim+1)."""
    lam0 = 1.0 - points.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, points], axis=1)


def _bary_grads(dim: int) -> np.ndarray:
    """Gradients of barycentric coordinates wrt reference coords: (dim+1, dim)."""
    g = np.zeros((dim + 1, dim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


def tabulate(dim: int, degree: int, points: np.ndarray):
    """Tabulate scalar Lagrange basis at reference points.

    Returns (phi (nq, nb), dphi (nq, nb, dim)) where dphi are gradients in
    *reference* coordinates.
    """
    lam = _bary(points)  # (nq, dim+1)
    glam = _bary_grads(dim)  # (dim+1, dim)
    nq = points.shape[0]
    nv = dim + 1
    if degree == 1:
        phi = lam
        dphi = np.broadcast_to(glam[None, :, :], (nq, nv, dim)).copy()
        return phi, dphi
    if degree == 2:
        edges = edge_list(dim)
        ne = edges.shape[0]
        nb = nv + ne
        phi = np.zeros((nq, nb))
        dphi = np.zeros((nq, nb, dim))
        # vertex functions: l(2l - 1)
        for i in range(nv):
            phi[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
            dphi[:, i, :] = (4.0 * lam[:, i] - 1.0)[:, None] * glam[i][None, :]
        # edge functions: 4 l_j l_k
        for e, (j, k) in enumerate(edges):
            phi[:, nv + e] = 4.0 * lam[:, j] * lam[:, k]
            dphi[:, nv + e, :] = 4.0 * (
                lam[:, j][:, None] * glam[k][None, :]
                + lam[:, k][:, None] * glam[j][None, :]
            )
        return phi, dphi
    if degree == 3:
        edges = edge_list(dim)
        ne = edges.shape[0]
        faces = _bubble_faces(dim)
        nb = nv + 2 * ne + len(faces)
        phi = np.zeros((nq, nb))
        dphi = np.zeros((nq, nb, dim))
        # vertex functions: l (3l - 1)(3l - 2) / 2
        for i in range(nv):
            li = lam[:, i]
            phi[:, i] = 0.5 * li * (3.0 * li - 1.0) * (3.0 * li - 2.0)
            dcoef = 0.5 * (27.0 * li * li - 18.0 * li + 2.0)
            dphi[:, i, :] = dcoef[:, None] * glam[i][None, :]
        # edge functions: 9/2 l_j l_k (3 l_near - 1), node nearer j first
        for e, (j, k) in enumerate(edges):
            lj, lk = lam[:, j], lam[:, k]
            for s, (a, bb) in enumerate(((j, k), (k, j))):
                la, lb = lam[:, a], lam[:, bb]
                idx = nv + 2 * e + s
                phi[:, idx] = 4.5 * la * lb * (3.0 * la - 1.0)
                # d/dla = 9/2 lb (6 la - 1); d/dlb = 9/2 la (3 la - 1)
                dphi[:, idx, :] = (
                    (4.5 * lb * (6.0 * la - 1.0))[:, None] * glam[a][None, :]
                    + (4.5 * la * (3.0 * la - 1.0))[:, None] * glam[bb][None, :]
                )
        # face/interior bubbles: 27 l_j l_k l_l
        for fi, (j, k, l) in enumerate(faces):
            lj, lk, ll = lam[:, j], lam[:, k], lam[:, l]
            idx = nv + 2 * ne + fi
            phi[:, idx] = 27.0 * lj * lk * ll
            dphi[:, idx, :] = 27.0 * (
                (lk * ll)[:, None] * glam[j][None, :]
                + (lj * ll)[:, None] * glam[k][None, :]
                + (lj * lk)[:, None] * glam[l][None, :]
            )
        return phi, dphi
    raise ValueError(f"unsupported degree {degree}")


def _bubble_faces(dim: int):
    """Index triples carrying the P3 cubic bubbles: the cell itself in 2D,
    each facet (TET_FACETS order) in 3D, none in 1D."""
    if dim == 1:
        return []
    if dim == 2:
        return [(0, 1, 2)]
    return [tuple(f) for f in TET_FACETS]


def num_basis(dim: int, degree: int) -> int:
    nv = dim + 1
    if degree == 1:
        return nv
    if degree == 2:
        return nv + edge_list(dim).shape[0]
    if degree == 3:
        return nv + 2 * edge_list(dim).shape[0] + len(_bubble_faces(dim))
    raise ValueError(f"unsupported degree {degree}")


def facet_embed(dim: int, facet_points: np.ndarray, local_facet_vertices):
    """Map reference-facet quadrature points into reference-cell coordinates.

    ``facet_points``: (nq, dim-1) points on the reference facet simplex.
    ``local_facet_vertices``: the cell-local vertex indices of the facet.
    Returns (nq, dim) reference-cell coordinates via the affine facet chart.
    """
    # reference cell vertex coordinates
    verts = np.vstack([np.zeros(dim), np.eye(dim)])  # (dim+1, dim)
    v = verts[np.asarray(local_facet_vertices)]  # (dim, dim)
    lam_f = _bary_facet(facet_points)  # (nq, dim)
    return lam_f @ v


def _bary_facet(points: np.ndarray) -> np.ndarray:
    lam0 = 1.0 - points.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, points], axis=1)

# Frozen copy of porotpu_torch/fem/assemble.py, the benchmark reference's own: later changes to the port do not reach it.
"""Vectorized FE assembly of the poromechanics bilinear/linear forms.

Replaces FFC/UFL-generated C++ element kernels + DOLFIN parallel assembly
(reference: every ``assemble(...)`` in lib/Assembler.py).

Performance design: all cells are affine, so every element tensor is
quadrature-separable — a tiny *reference tensor* (integrals of basis
products on the reference simplex, computed once) contracted with
per-cell geometry factors (invJ^T, detJ).  Assembly is then a handful of
BLAS-shaped einsums over (cells, 9, nb*nb) instead of per-cell
quadrature loops, plus one COO->CSR scatter with cached index arrays.

Element-matrix identities (g = physical basis gradients):
  mass:        E[(a,c),(b,d)] = delta_cd  ∫ phi_a phi_b
  eps:eps:     E[(a,c),(b,d)] = 1/2 ∫ ( delta_cd  grad phi_a . grad phi_b
                                        + d_d phi_a  d_c phi_b )
  div div:     E[(a,c),(b,d)] = ∫ d_c phi_a  d_d phi_b
  q div(u):    E[a,(b,d)]     = ∫ psi_a  d_d phi_b
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import elements, quadrature
from .dofmap import FunctionSpace


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def cell_geometry(mesh):
    """Affine cell maps: returns (invJT (nc, dim, dim), detJ (nc,))."""
    if getattr(mesh, "_geom_cache", None) is not None:
        return mesh._geom_cache
    v = mesh.vertices[mesh.cells]  # (nc, dim+1, dim)
    J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))  # (nc, dim, dim)
    detJ = np.abs(np.linalg.det(J))
    invJ = np.linalg.inv(J)
    invJT = np.transpose(invJ, (0, 2, 1))
    mesh._geom_cache = (invJT, detJ)
    return mesh._geom_cache


# ---------------------------------------------------------------------------
# reference tensors (computed once per (dim, degree) pair)
# ---------------------------------------------------------------------------

_REF_CACHE: dict = {}


def _ref_tensors(dim: int, deg_test: int, deg_trial: int):
    """Reference-simplex integrals:
    Mref[a,b]     = ∫ phi_a phi_b
    Kref[m,n,a,b] = ∫ d_m phi_a d_n phi_b      (reference gradients)
    Dref[m,a,b]   = ∫ psi_a d_m phi_b          (psi = test basis)
    """
    key = (dim, deg_test, deg_trial)
    if key in _REF_CACHE:
        return _REF_CACHE[key]
    qdeg = 2 * max(deg_test, deg_trial)
    pts, wts = quadrature.simplex_rule(dim, qdeg)
    phi_t, dphi_t = elements.tabulate(dim, deg_test, pts)
    phi_u, dphi_u = elements.tabulate(dim, deg_trial, pts)
    Mref = np.einsum("q,qa,qb->ab", wts, phi_t, phi_u, optimize=True)
    Kref = np.einsum("q,qam,qbn->mnab", wts, dphi_t, dphi_u, optimize=True)
    Dref = np.einsum("q,qa,qbm->mab", wts, phi_t, dphi_u, optimize=True)
    _REF_CACHE[key] = (Mref, Kref, Dref)
    return _REF_CACHE[key]


# ---------------------------------------------------------------------------
# scatter with cached indices
# ---------------------------------------------------------------------------


def _scatter_indices(test: FunctionSpace, trial: FunctionSpace):
    cache = getattr(test, "_scatter_cache", None)
    if cache is None:
        cache = test._scatter_cache = {}
    key = id(trial)
    if key not in cache:
        rd = test.cell_dofs.astype(np.int32)
        cd = trial.cell_dofs.astype(np.int32)
        rows = np.repeat(rd[:, :, None], cd.shape[1], axis=2).ravel()
        cols = np.repeat(cd[:, None, :], rd.shape[1], axis=1).ravel()
        cache[key] = (rows, cols)
    return cache[key]


def _scatter_matrix(test: FunctionSpace, trial: FunctionSpace, E) -> sp.csr_matrix:
    """E: (nc, nb_test_dofs, nb_trial_dofs) element matrices."""
    rows, cols = _scatter_indices(test, trial)
    A = sp.coo_matrix(
        (E.reshape(-1), (rows, cols)), shape=(test.num_dofs, trial.num_dofs)
    ).tocsr()
    A.sum_duplicates()
    return A


def _expand_vector_mass(M_block, detJ, dim):
    """E[e, (a,c), (b,d)] = delta_cd detJ_e M_block[a,b]."""
    na, nb = M_block.shape
    nc = detJ.shape[0]
    out = np.zeros((nc, na * dim, nb * dim))
    blk = detJ[:, None, None] * M_block[None, :, :]
    for c in range(dim):
        out[:, c::dim, c::dim] = blk
    return out


# ---------------------------------------------------------------------------
# bilinear forms
# ---------------------------------------------------------------------------


def mass(space: FunctionSpace, coeff: float = 1.0, qdeg=None) -> sp.csr_matrix:
    """coeff * ∫ u v  (scalar) or coeff * ∫ u . v (vector)."""
    Mref, _, _ = _ref_tensors(space.dim, space.degree, space.degree)
    _, detJ = cell_geometry(space.mesh)
    if space.vector:
        E = coeff * _expand_vector_mass(Mref, detJ, space.ncomp)
    else:
        E = coeff * detJ[:, None, None] * Mref[None, :, :]
    return _scatter_matrix(space, space, E)


def mass_coupling(
    test: FunctionSpace, trial: FunctionSpace, coeff: float = 1.0
) -> sp.csr_matrix:
    """coeff * ∫ u . v between two (same-mesh) vector spaces.

    Used for the Darcy drag coupling blocks (reference lib/Assembler.py:83,89).
    """
    assert test.mesh is trial.mesh
    Mref, _, _ = _ref_tensors(test.dim, test.degree, trial.degree)
    _, detJ = cell_geometry(test.mesh)
    if test.vector:
        E = coeff * _expand_vector_mass(Mref, detJ, test.ncomp)
    else:
        E = coeff * detJ[:, None, None] * Mref[None, :, :]
    return _scatter_matrix(test, trial, E)


def _grad_contraction(space):
    """C[e,m,n] = sum_k invJT[e,k,m] invJT[e,k,n] * detJ[e]."""
    invJT, detJ = cell_geometry(space.mesh)
    return np.einsum("ekm,ekn,e->emn", invJT, invJT, detJ, optimize=True)


def stiffness(space: FunctionSpace, coeff: float = 1.0) -> sp.csr_matrix:
    """coeff * ∫ grad p . grad q  (scalar space)."""
    _, Kref, _ = _ref_tensors(space.dim, space.degree, space.degree)
    C = _grad_contraction(space)
    dim = space.dim
    nb = Kref.shape[-1]
    E = np.einsum(
        "emn,mnab->eab", C, Kref, optimize=True
    ) * coeff
    return _scatter_matrix(space, space, E)


def _partial_products(space):
    """S[(d,c)][e,a,b] = detJ ∫ d_d phi_a d_c phi_b (physical gradients).

    Computed as invJT[e,d,m] invJT[e,c,n] Kref[m,n,a,b] detJ[e] — one BLAS
    einsum per (d,c) pair.
    """
    _, Kref, _ = _ref_tensors(space.dim, space.degree, space.degree)
    invJT, detJ = cell_geometry(space.mesh)
    dim = space.dim
    Kf = Kref.reshape(dim * dim, -1)  # (m*n, a*b)
    nb = Kref.shape[-1]
    out = {}
    for d in range(dim):
        for c in range(dim):
            # W[e, m*n] = invJT[e,d,m] invJT[e,c,n] * detJ
            W = (
                invJT[:, d, :, None] * invJT[:, c, None, :]
            ).reshape(len(detJ), -1) * detJ[:, None]
            out[(d, c)] = (W @ Kf).reshape(len(detJ), nb, nb)
    return out


def eps_eps(space: FunctionSpace, coeff: float = 1.0) -> sp.csr_matrix:
    """coeff * ∫ eps(u) : eps(v)  (vector space)."""
    assert space.vector
    dim = space.ncomp
    S = _partial_products(space)
    K = sum(S[(k, k)] for k in range(dim))  # grad.grad
    nc, na, nb = K.shape
    E = np.zeros((nc, na * dim, nb * dim))
    for c in range(dim):
        for d in range(dim):
            blk = 0.5 * S[(d, c)]
            if c == d:
                blk = blk + 0.5 * K
            E[:, c::dim, d::dim] = blk
    return _scatter_matrix(space, space, coeff * E)


def divdiv(space: FunctionSpace, coeff: float = 1.0) -> sp.csr_matrix:
    """coeff * ∫ div(u) div(v)  (vector space)."""
    assert space.vector
    dim = space.ncomp
    S = _partial_products(space)
    nc = space.mesh.num_cells
    na = nb = S[(0, 0)].shape[1]
    E = np.zeros((nc, na * dim, nb * dim))
    for c in range(dim):
        for d in range(dim):
            E[:, c::dim, d::dim] = S[(c, d)]
    return _scatter_matrix(space, space, coeff * E)


def hooke(space: FunctionSpace, mu: float, lam: float) -> sp.csr_matrix:
    """∫ hooke(eps(u)) : eps(v) = 2 mu eps:eps + lam div div.

    (reference lib/Assembler.py:69-70) — assembled in a single element
    tensor + one scatter.
    """
    dim = space.ncomp
    S = _partial_products(space)
    K = sum(S[(k, k)] for k in range(dim))
    nc, na, nb = K.shape
    E = np.zeros((nc, na * dim, nb * dim))
    for c in range(dim):
        for d in range(dim):
            blk = mu * S[(d, c)] + lam * S[(c, d)]
            if c == d:
                blk = blk + mu * K
            E[:, c::dim, d::dim] = blk
    return _scatter_matrix(space, space, E)


def div_coupling(
    test_scalar: FunctionSpace, trial_vec: FunctionSpace, coeff: float = 1.0
) -> sp.csr_matrix:
    """coeff * ∫ q div(u): rows = scalar test, cols = vector trial.

    (reference lib/Assembler.py:92-93: div(phi vf) q terms)
    """
    assert trial_vec.vector and not test_scalar.vector
    mesh = test_scalar.mesh
    dim = mesh.dim
    _, _, Dref = _ref_tensors(dim, test_scalar.degree, trial_vec.degree)
    invJT, detJ = cell_geometry(mesh)
    na, nb = Dref.shape[1], Dref.shape[2]
    nc = mesh.num_cells
    E = np.zeros((nc, na, nb * dim))
    Df = Dref.reshape(dim, -1)  # (m, a*b)
    for d in range(dim):
        # physical d-th partial: sum_m invJT[e,d,m] Dref[m,a,b] * detJ
        W = invJT[:, d, :] * detJ[:, None]  # (e, m)
        E[:, :, d::dim] = (W @ Df).reshape(nc, na, nb)
    return _scatter_matrix(test_scalar, trial_vec, coeff * E)


# ---------------------------------------------------------------------------
# linear forms (loads)
# ---------------------------------------------------------------------------


def cell_load(space: FunctionSpace, f_at_nodes=None, f_const=None) -> np.ndarray:
    """∫ f . v dx with f constant (f_const) or nodal (f_at_nodes).

    ``f_at_nodes`` is the load interpolated onto the space's own nodes
    (flat, component-interleaved for vector spaces, length num_dofs): the
    assembled form is then exactly M @ f with M the space's mass matrix,
    computed cell-wise — matching the reference's assembly of arbitrary
    expression-valued volume loads fs_vol/ff_vol/p_source
    (lib/Assembler.py:243-259) up to interpolation of f.

    Returns dense vector of size space.num_dofs.
    """
    pts, wts = quadrature.simplex_rule(space.dim, 2 * space.degree)
    phi, _ = elements.tabulate(space.dim, space.degree, pts)
    _, detJ = cell_geometry(space.mesh)
    b = np.zeros(space.num_dofs)
    if f_const is not None:
        f_const = np.atleast_1d(np.asarray(f_const, dtype=float))
        Fa_ref = np.einsum("q,qa->a", wts, phi)
        Fa = detJ[:, None] * Fa_ref[None, :]  # (nc, nb)
        if space.vector:
            for c in range(space.ncomp):
                np.add.at(b, space.cell_dofs[:, c :: space.ncomp], Fa * f_const[c])
        else:
            np.add.at(b, space.cell_dofs, Fa * float(f_const[0]))
        return b
    f = np.asarray(f_at_nodes, dtype=float).ravel()
    if f.size != space.num_dofs:
        raise ValueError(
            f"f_at_nodes has {f.size} values, space has {space.num_dofs} dofs"
        )
    # reference element mass: Me[a,b] = sum_q w_q phi_qa phi_qb (symmetric)
    Me = np.einsum("q,qa,qb->ab", wts, phi, phi)
    if space.vector:
        for c in range(space.ncomp):
            dofs_c = space.cell_dofs[:, c :: space.ncomp]
            np.add.at(b, dofs_c, detJ[:, None] * (f[dofs_c] @ Me))
    else:
        dofs = space.cell_dofs
        np.add.at(b, dofs, detJ[:, None] * (f[dofs] @ Me))
    return b


def _facet_tabulation(space: FunctionSpace, facet_ids: np.ndarray):
    """Facet-local P1/P2 tabulation + geometry for boundary facets.

    Returns (facet_dofnodes (nf, nbf), phi (nq, nbf), wts (nq,), detJ (nf,),
    points (nf, nq, dim), normals (nf, dim)).
    """
    mesh = space.mesh
    dim = mesh.dim
    f = mesh.boundary_facets[facet_ids]  # (nf, dim)
    verts = mesh.vertices
    # facet treated as a (dim-1)-simplex Lagrange element of same degree
    pts, wts = quadrature.facet_rule(dim, 2 * space.degree)
    fdim = dim - 1
    phi, _ = elements.tabulate(fdim, space.degree, pts)

    # facet node ids in space numbering (vert_node/edge_node maps account
    # for the lattice-lexicographic renumbering)
    nodes = [space.vert_node[f]]
    if space.degree == 2:
        if dim == 2:
            eids = space._edge_lookup(np.sort(f, axis=1))
            nodes.append(space.edge_node[eids][:, None])
        else:
            # P2 triangle edge ordering: (1,2), (0,2), (0,1)
            pairs = np.stack([f[:, [1, 2]], f[:, [0, 2]], f[:, [0, 1]]], axis=1)
            eids = space._edge_lookup(np.sort(pairs.reshape(-1, 2), axis=1))
            nodes.append(space.edge_node[eids].reshape(-1, 3))
    elif space.degree == 3:
        # facet-local edges in edge_list(fdim) order; per edge the node
        # nearer the FIRST local vertex comes first (fem/elements.py P3
        # ordering) — edge_node rows are [nearer smaller vertex, nearer
        # larger], so flip when the local pair runs large -> small
        fedges = elements.edge_list(fdim)  # interval (0,1) / TRI_EDGES
        pj = f[:, fedges[:, 0]]  # (nf, nle)
        pk = f[:, fedges[:, 1]]
        pairs = np.stack([pj, pk], axis=2).reshape(-1, 2)
        eids = space._edge_lookup(np.sort(pairs, axis=1))
        flip = (pairs[:, 0] > pairs[:, 1]).astype(np.int64)
        en = space.edge_node[eids]  # (nf*nle, 2)
        first = en[np.arange(en.shape[0]), flip]
        second = en[np.arange(en.shape[0]), 1 - flip]
        both = np.stack([first, second], axis=1).reshape(
            f.shape[0], -1
        )  # (nf, 2*nle) interleaved per local edge
        nodes.append(both)
        if dim == 3:
            nodes.append(
                space.face_node[space._face_lookup(np.sort(f, axis=1))][:, None]
            )
    fnodes = np.concatenate(nodes, axis=1)  # (nf, nbf)

    # geometry of the facet chart
    if dim == 2:
        t = verts[f[:, 1]] - verts[f[:, 0]]
        detJ = np.linalg.norm(t, axis=1)
        x = verts[f[:, 0]][:, None, :] + pts[None, :, :] * t[:, None, :]
    else:
        e1 = verts[f[:, 1]] - verts[f[:, 0]]
        e2 = verts[f[:, 2]] - verts[f[:, 0]]
        detJ = np.linalg.norm(np.cross(e1, e2), axis=1)
        x = (
            verts[f[:, 0]][:, None, :]
            + pts[None, :, 0:1] * e1[:, None, :]
            + pts[None, :, 1:2] * e2[:, None, :]
        )
    normals = mesh.boundary_facet_normals()[facet_ids]
    return fnodes, phi, wts, detJ, x, normals


def facet_load(space: FunctionSpace, measure, load, t: float) -> np.ndarray:
    """∫_dsN f(t) . v ds over the measure's tagged facets.

    ``load`` follows the loads API (models/loads.py): it evaluates to
    values at quadrature points given (t, x, n).
    Returns dense vector of size space.num_dofs.
    """
    b = np.zeros(space.num_dofs)
    fids = measure.facet_ids
    if fids.size == 0 or load is None:
        return b
    fnodes, phi, wts, detJ, x, normals = _facet_tabulation(space, fids)
    nf, nq = x.shape[0], x.shape[1]
    vals = load.eval(t, x.reshape(-1, x.shape[-1]), np.repeat(normals, nq, axis=0))
    if space.vector:
        vals = np.asarray(vals, dtype=float).reshape(nf, nq, space.ncomp)
        # F[f, a, c] = sum_q w_q detJ_f vals[f,q,c] phi[q,a]
        F = np.einsum("q,fqc,qa,f->fac", wts, vals, phi, detJ, optimize=True)
        for c in range(space.ncomp):
            np.add.at(b, fnodes * space.ncomp + c, F[:, :, c])
    else:
        vals = np.asarray(vals, dtype=float).reshape(nf, nq)
        F = np.einsum("q,fq,qa,f->fa", wts, vals, phi, detJ, optimize=True)
        np.add.at(b, fnodes, F)
    return b

# Frozen copy of porotpu_torch/fem/bcs.py, the benchmark reference's own: later changes to the port do not reach it.
"""Dirichlet boundary conditions with DOLFIN row-surgery semantics.

Reference behavior (lib/Poromechanics.py:76-83): ``bc.apply(A|P|b)`` zeroes
the Dirichlet rows of the matrix, puts 1 on the diagonal, and sets the RHS
entries to the BC value.  Columns are untouched (nonsymmetric application),
exactly as DOLFIN's DirichletBC.apply.

BCs are defined on a field of a MixedSpace, optionally on a single
component (reference: ``DirichletBC(V.sub(0).sub(0), ...)`` in
swelling.py:95-96), with the facet selection given by marker tags or by a
geometric predicate (``boundary_foot`` in footing.py:102-108).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .dofmap import MixedSpace


class DirichletBC:
    def __init__(
        self,
        mixed: MixedSpace,
        field: str,
        value,
        markers=None,
        tags=None,
        predicate=None,
        component=None,
    ):
        """Dirichlet condition ``field[component] = value`` on boundary nodes.

        - markers+tags: nodes on boundary facets whose tag is in ``tags``
        - predicate: callable(x (n, dim)) -> bool mask over boundary nodes
        (both can be combined; union of the selections)
        """
        self.mixed = mixed
        self.field = field
        space = mixed.space(field)

        nodes = []
        if markers is not None and tags is not None:
            tl = tags if isinstance(tags, (list, tuple, np.ndarray)) else [tags]
            fids = markers.facets_with(tl)
            nodes.append(space.facet_nodes(fids))
        if predicate is not None:
            bnodes = space.boundary_nodes()
            x = space.node_coords[bnodes]
            mask = np.asarray(predicate(x), dtype=bool)
            nodes.append(bnodes[mask])
        if not nodes:
            raise ValueError("DirichletBC needs markers+tags or a predicate")
        nodes = np.unique(np.concatenate(nodes))

        local = space.nodes_to_dofs(nodes, component=component)
        self.dofs = mixed.global_dofs(field, local)  # global (mixed) dof ids
        self.local_dofs = local  # within-field dof ids

        value = np.atleast_1d(np.asarray(value, dtype=float))
        if component is None and space.vector:
            if value.size == 1:
                value = np.repeat(value, space.ncomp)
            self.values = np.tile(value, nodes.size)
        else:
            self.values = np.repeat(value[:1], self.dofs.size)
        assert self.values.size == self.dofs.size


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def bc_dofs_values(bcs) -> tuple[np.ndarray, np.ndarray]:
    """Union of all BC dofs and values (later BCs win on duplicates)."""
    if not bcs:
        return np.zeros(0, np.int64), np.zeros(0)
    dofs = np.concatenate([bc.dofs for bc in bcs])
    vals = np.concatenate([bc.values for bc in bcs])
    # keep last occurrence
    _, idx = np.unique(dofs[::-1], return_index=True)
    idx = dofs.size - 1 - idx
    return dofs[idx], vals[idx]


def apply_bcs_matrix(A: sp.csr_matrix, dofs: np.ndarray) -> sp.csr_matrix:
    """Zero the given rows and set the diagonal to 1 (DOLFIN bc.apply(A))."""
    A = A.tocsr(copy=True)
    mask = np.zeros(A.shape[0], dtype=bool)
    mask[dofs] = True
    row_of_nnz = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    A.data[mask[row_of_nnz]] = 0.0
    # ensure unit diagonal on BC rows
    d = sp.csr_matrix(
        (np.ones(dofs.size), (dofs, dofs)), shape=A.shape
    )
    # remove any existing diagonal on those rows first (they were zeroed),
    # then add 1
    A = (A + d).tocsr()
    A.sum_duplicates()
    return A


def zero_rows(A: sp.csr_matrix, rows: np.ndarray, unit_diag=False) -> sp.csr_matrix:
    """Per-block BC row surgery: zero the rows; optionally set diag to 1.

    The per-field-block equivalent of apply_bcs_matrix on the monolithic
    operator (diagonal blocks get the unit diagonal, off-diagonal blocks
    just lose their BC rows) — lets _build_operators skip the
    bmat/pad/re-slice round trip over the full nnz.
    """
    A = A.tocsr(copy=True)
    if rows.size == 0:
        return A
    mask = np.zeros(A.shape[0], dtype=bool)
    mask[rows] = True
    row_of_nnz = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    A.data[mask[row_of_nnz]] = 0.0
    if unit_diag:
        d = sp.csr_matrix(
            (np.ones(rows.size), (rows, rows)), shape=A.shape
        )
        A = (A + d).tocsr()
        A.sum_duplicates()
    return A


def apply_bcs_vector(b: np.ndarray, dofs: np.ndarray, values: np.ndarray):
    b = np.array(b, copy=True)
    b[dofs] = values
    return b

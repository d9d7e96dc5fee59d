# Copy of porotpu/fem/meshio.py, behaviour unchanged.
"""Mesh file I/O: XDMF/HDF5 save + load and the prolate-geometry loader.

The reference's prolateGeometry (lib/MeshCreation.py:146-166) reads a
heart-ventricle mesh + facet markers from ``meshes/<name>.xdmf`` (the
meshes directory is not shipped with the reference and no driver uses it);
this module provides the equivalent capability against the XDMF/HDF5
layout written by save_mesh_xdmf:

  mesh/vertices (nv, dim), mesh/cells (nc, dim+1)
  markers/facets (nmf, dim) facet vertex ids, markers/values (nmf,)
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import Mesh, BoundaryMarkers

ENDOCARD, EPICARD, BASE = 20, 10, 50


def save_mesh_xdmf(basename: str, mesh: Mesh, markers: BoundaryMarkers | None = None):
    import h5py

    os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)
    with h5py.File(basename + ".h5", "w") as f:
        f.create_dataset("mesh/vertices", data=mesh.vertices)
        f.create_dataset("mesh/cells", data=mesh.cells.astype(np.int64))
        if markers is not None:
            f.create_dataset(
                "markers/facets", data=mesh.boundary_facets.astype(np.int64)
            )
            f.create_dataset("markers/values", data=markers.tags.astype(np.int64))
    topo = "Triangle" if mesh.dim == 2 else "Tetrahedron"
    geom = "XY" if mesh.dim == 2 else "XYZ"
    h5 = os.path.basename(basename) + ".h5"
    nv, nc = mesh.num_vertices, mesh.num_cells
    with open(basename + ".xdmf", "w") as f:
        f.write(
            '<?xml version="1.0"?>\n<Xdmf Version="3.0">\n<Domain>\n'
            '<Grid Name="mesh" GridType="Uniform">\n'
            f'<Topology TopologyType="{topo}" NumberOfElements="{nc}">\n'
            f'<DataItem Dimensions="{nc} {mesh.cells.shape[1]}" Format="HDF">'
            f"{h5}:/mesh/cells</DataItem>\n</Topology>\n"
            f'<Geometry GeometryType="{geom}">\n'
            f'<DataItem Dimensions="{nv} {mesh.dim}" Format="HDF">'
            f"{h5}:/mesh/vertices</DataItem>\n</Geometry>\n"
            "</Grid>\n</Domain>\n</Xdmf>\n"
        )


def load_mesh_xdmf(basename: str):
    """Load (mesh, markers-or-None) from <basename>.h5 (XDMF companion)."""
    import h5py

    path = basename + ".h5" if not basename.endswith(".h5") else basename
    with h5py.File(path, "r") as f:
        verts = f["mesh/vertices"][...]
        cells = f["mesh/cells"][...].astype(np.int64)
        mk_facets = f["markers/facets"][...] if "markers/facets" in f else None
        mk_values = f["markers/values"][...] if "markers/values" in f else None
    mesh = Mesh(verts.shape[1], np.asarray(verts, dtype=float), cells)
    markers = None
    if mk_facets is not None:
        markers = _markers_from_facet_list(mesh, mk_facets, mk_values)
    return mesh, markers


def _markers_from_facet_list(mesh: Mesh, facets: np.ndarray, values: np.ndarray):
    """Build BoundaryMarkers whose tags come from a stored facet list."""
    bf = np.sort(mesh.boundary_facets, axis=1)
    key_dim = mesh.num_vertices + 1
    def enc(f):
        k = np.zeros(f.shape[0], dtype=np.int64)
        for c in range(f.shape[1]):
            k = k * key_dim + f[:, c]
        return k

    order = np.argsort(enc(bf))
    stored = np.sort(np.asarray(facets, dtype=np.int64), axis=1)
    pos = np.searchsorted(enc(bf)[order], enc(stored))
    pos = np.clip(pos, 0, len(order) - 1)
    idx = order[pos]
    ok = np.all(bf[idx] == stored, axis=1)

    mk = BoundaryMarkers.__new__(BoundaryMarkers)
    mk.mesh = mesh
    mk.tags = np.zeros(bf.shape[0], dtype=np.int64)
    mk.tags[idx[ok]] = np.asarray(values, dtype=np.int64)[ok]
    mk.midpoints = mesh.vertices[mesh.boundary_facets].mean(axis=1)
    return mk


def prolateGeometry(filename: str, meshes_dir: str = "meshes"):
    """Reference-parity loader (lib/MeshCreation.py:146-166): loads
    ``meshes/<filename>.xdmf``-companion data, scales coordinates by 1e-3,
    returns (mesh, markers, ENDOCARD, EPICARD, BASE, NONE)."""
    from .mesh import NONE

    mesh, markers = load_mesh_xdmf(os.path.join(meshes_dir, filename))
    mesh.vertices = mesh.vertices * 1e-3
    return mesh, markers, ENDOCARD, EPICARD, BASE, NONE

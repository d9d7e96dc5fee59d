# Copy of porotpu/utils/io.py; checkpoints hold the port's torch tensors in porotpu's npz layout.
"""Solution export and checkpoint/resume.

The reference exports XDMF time series of the three fields
(lib/AbstractPhysics.py:34-38,47-57) and has no checkpointing (SURVEY.md
§5).  Here:
- TimeSeriesWriter: VTU (XML unstructured grid) per step + a PVD index —
  dependency-free, ParaView-readable; equivalent capability to the XDMF
  export.
- save_checkpoint / load_checkpoint: npz dump of the time-stepping state
  (us_nm1, us_nm2, uf_nm1, p_nm1, t) enabling resume — the addition
  SURVEY.md §5 calls for.
"""

from __future__ import annotations

import os

import numpy as np
import torch


_VTK_CELL = {2: 5, 3: 10}  # triangle, tetra


class TimeSeriesWriter:
    def __init__(self, basename: str, mesh):
        self.basename = basename
        self.mesh = mesh
        self.steps = []
        os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)

    def write(self, t: float, fields: dict):
        """fields: {name: dof vector}; vector fields have node-interleaved
        dofs; only vertex values are exported (P2 edge dofs dropped)."""
        mesh = self.mesh
        nv = mesh.num_vertices
        dim = mesh.dim
        fname = f"{self.basename}_{len(self.steps):06d}.vtu"
        cells = mesh.cells
        npc = cells.shape[1]

        with open(fname, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write(
                '<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n'
            )
            f.write(
                f'<Piece NumberOfPoints="{nv}" NumberOfCells="{len(cells)}">\n'
            )
            f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
            pts = np.zeros((nv, 3))
            pts[:, :dim] = mesh.vertices
            np.savetxt(f, pts, fmt="%.10g")
            f.write("</DataArray>\n</Points>\n<Cells>\n")
            f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
            np.savetxt(f, cells, fmt="%d")
            f.write('</DataArray>\n<DataArray type="Int32" Name="offsets" format="ascii">\n')
            np.savetxt(f, np.arange(1, len(cells) + 1) * npc, fmt="%d")
            f.write('</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
            np.savetxt(f, np.full(len(cells), _VTK_CELL[dim]), fmt="%d")
            f.write("</DataArray>\n</Cells>\n<PointData>\n")
            for name, vec in fields.items():
                vec = np.asarray(vec)
                if vec.size % nv == 0 and vec.size // nv in (1, dim) and vec.size == nv:
                    comp, data = 1, vec[:, None]
                else:
                    # node-interleaved vector or P2 field: keep vertex nodes
                    nnode = vec.size // dim if vec.size % dim == 0 else vec.size
                    if vec.size % dim == 0 and vec.size // dim >= nv:
                        data = vec.reshape(-1, dim)[:nv]
                        comp = 3
                        pad = np.zeros((nv, 3))
                        pad[:, :dim] = data
                        data = pad
                    else:
                        data = vec[:nv, None]
                        comp = 1
                safe = name.replace(" ", "_")
                f.write(
                    f'<DataArray type="Float64" Name="{safe}" '
                    f'NumberOfComponents="{comp}" format="ascii">\n'
                )
                np.savetxt(f, data, fmt="%.10g")
                f.write("</DataArray>\n")
            f.write("</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")

        self.steps.append((t, os.path.basename(fname)))
        self._write_pvd()

    def _write_pvd(self):
        with open(f"{self.basename}.pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" version="0.1">\n<Collection>\n')
            for t, fn in self.steps:
                f.write(f'<DataSet timestep="{t}" file="{fn}"/>\n')
            f.write("</Collection>\n</VTKFile>\n")


class XDMFWriter:
    """XDMF + HDF5 time-series export (the reference's output format,
    lib/AbstractPhysics.py:34-38: functions_share_mesh, flush_output,
    rewrite_function_mesh=False -> mesh written once, fields per step)."""

    def __init__(self, basename: str, mesh):
        import h5py

        self.basename = basename
        self.mesh = mesh
        self.steps = []
        os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)
        self.h5path = basename + ".h5"
        self.h5 = h5py.File(self.h5path, "w")
        self.h5.create_dataset("mesh/vertices", data=mesh.vertices)
        self.h5.create_dataset("mesh/cells", data=mesh.cells.astype(np.int64))

    def write(self, t: float, fields: dict):
        gid = f"step_{len(self.steps):06d}"
        g = self.h5.create_group(gid)
        mesh = self.mesh
        nv = mesh.num_vertices
        dim = mesh.dim
        names = []
        for name, vec in fields.items():
            vec = np.asarray(vec)
            safe = name.replace(" ", "_")
            if vec.size % dim == 0 and vec.size // dim >= nv and vec.size != nv:
                data = vec.reshape(-1, dim)[:nv]  # vertex values of vector
            else:
                data = vec[:nv]
            g.create_dataset(safe, data=data)
            names.append((safe, data.ndim))
        self.h5.flush()
        self.steps.append((t, gid, names))
        self._write_xdmf()

    def _write_xdmf(self):
        mesh = self.mesh
        dim = mesh.dim
        topo = "Triangle" if dim == 2 else "Tetrahedron"
        h5 = os.path.basename(self.h5path)
        nv, nc = mesh.num_vertices, mesh.num_cells
        npc = mesh.cells.shape[1]
        with open(self.basename + ".xdmf", "w") as f:
            f.write('<?xml version="1.0"?>\n<Xdmf Version="3.0">\n<Domain>\n')
            f.write(
                '<Grid Name="TimeSeries" GridType="Collection" '
                'CollectionType="Temporal">\n'
            )
            for t, gid, names in self.steps:
                f.write(f'<Grid Name="{gid}" GridType="Uniform">\n')
                f.write(f'<Time Value="{t}"/>\n')
                f.write(
                    f'<Topology TopologyType="{topo}" NumberOfElements="{nc}">\n'
                    f'<DataItem Dimensions="{nc} {npc}" Format="HDF">'
                    f"{h5}:/mesh/cells</DataItem>\n</Topology>\n"
                )
                geom = "XY" if dim == 2 else "XYZ"
                f.write(
                    f'<Geometry GeometryType="{geom}">\n'
                    f'<DataItem Dimensions="{nv} {dim}" Format="HDF">'
                    f"{h5}:/mesh/vertices</DataItem>\n</Geometry>\n"
                )
                for safe, ndim_ in names:
                    att = "Vector" if ndim_ == 2 else "Scalar"
                    dims = f"{nv} {dim}" if ndim_ == 2 else f"{nv}"
                    f.write(
                        f'<Attribute Name="{safe}" AttributeType="{att}" '
                        f'Center="Node">\n<DataItem Dimensions="{dims}" '
                        f'Format="HDF">{h5}:/{gid}/{safe}</DataItem>\n'
                        "</Attribute>\n"
                    )
                f.write("</Grid>\n")
            f.write("</Grid>\n</Domain>\n</Xdmf>\n")

    def close(self):
        self.h5.close()


def save_checkpoint(path: str, problem, t: float):
    """Dump the time-stepping state for resume: porotpu's npz keys and its
    padded layout, so that either package resumes from the other's file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        t=t,
        us_nm1=problem.us_nm1.cpu().numpy(),
        us_nm2=problem.us_nm2.cpu().numpy(),
        uf_nm1=problem.uf_nm1.cpu().numpy(),
        p_nm1=problem.p_nm1.cpu().numpy(),
    )


def load_checkpoint(path: str, problem):
    """Restore the time-stepping state at ``problem.dtype`` onto
    ``problem.device``; returns the checkpoint time."""
    with np.load(path) as d:
        for key in ("us_nm1", "us_nm2", "uf_nm1", "p_nm1"):
            setattr(problem, key, torch.as_tensor(d[key], dtype=problem.dtype).to(problem.device))
        problem.t = float(d["t"])
    return problem.t

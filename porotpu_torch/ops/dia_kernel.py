"""The banded kernels, their plain PyTorch versions and their dispatch.

- K1 ``dia_mv``: y[i] = sum_d data[d, i] * xe[i + off_d], xe read as zero
  outside [0, ne) (porotpu/ops/pallas_dia.py:mv; ``csrc/dia_mv.cu``).
- K2 ``dia_rmv``: the transpose from A's own layout, y[j] = sum_d
  data[d, j - off_d] * x[j - off_d] over the rows 0 <= j - off_d < nrows
  (porotpu/ops/pallas_dia.py:rmv; ``csrc/dia_rmv.cu``).
- K3 ``dia_mv_padded``: K1 on an input already zero-padded by
  lo = max(0, -min off) and hi = max(0, max off), no bounds test
  (tools/pallas_dia.py:pallas_dia_matvec; ``csrc/dia_mv_padded.cu``).

The dispatch functions ``mv`` and ``rmv`` launch the CUDA kernel for a
CUDA tensor and run the plain version (``*_ref``) for a CPU tensor.  There
is no fallback between the two: a CUDA tensor whose kernel fails to build
or launch raises.  K3's only caller, the microbench, runs on the card and
launches ``dia_mv_padded`` directly.

K1 and K2 share one frame (``csrc/dia_tile.cuh``): tiles of 256 (f32) or
128 (f64) outputs, diagonals split over the warps of a block and, on
operators with few tiles, over the blocks of a thread-block cluster.
``launch_plan`` picks the warps and the cluster from the shapes alone.

Every ``csrc/*.cu`` is compiled by ``nvcc`` at first use, one process per
source, all started together, and linked into one library under
``build/porotpu_torch_ext/`` at the repository root (rebuilt when any
source is newer than the library).  It is bound through ctypes: the C entry
points take raw device pointers and the current stream, so neither ninja
nor PyTorch's headers are needed.  The library also holds the ELL kernel
(``csrc/ell_mv.cu``), which ``ops/sparse.py`` plans and launches.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import glob
import os
import shutil
import subprocess
import tempfile
import time

import torch
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "porotpu_torch_ext")
LIBRARY = os.path.join(BUILD_DIR, "libporotpu_torch_ext.so")
NVCC_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# K3 stages its offsets in the default 48 KB of dynamic shared memory
MAX_DIAGONALS = 48 * 1024 // 4

# Dispatch counts, read by chip_smoke.py: "dia_mv", "dia_rmv" and
# "dia_mv_padded" count launches of each CUDA kernel (incremented only
# where it launches), "plain" counts products taken by a plain PyTorch
# version through the dispatch functions.
COUNTS = {"dia_mv": 0, "dia_rmv": 0, "dia_mv_padded": 0, "plain": 0}
# The same launches by operator: (kernel, dtype, nd, nrows) -> launches.
LAUNCHES = collections.Counter()
# The launches among them that took the masked scalar path (a length that
# is not a whole number of 16-byte chunks, or an unaligned input).
SCALAR_LAUNCHES = collections.Counter()
# The products of ``mv`` (K1) and ``rmv`` (K2), on every device, by the
# diagonal values they stream: kernel -> values stored (nd x nrows a
# product) and how many of them are structural nonzeros (the operator's
# ``nnz``, counted when it was built).  A product whose caller gives no
# ``nnz`` is left out of both.
STORED = {"dia_mv": 0, "dia_rmv": 0}
NONZERO = {"dia_mv": 0, "dia_rmv": 0}
# K1's stored values by the path of its launch: "vector" (16-byte chunks)
# or "scalar" (``SCALAR_LAUNCHES``'s masked path).  A product on a CPU
# tensor, which the plain version computes, counts the path a launch of
# its operands would take.
K1_PATH = {"vector": 0, "scalar": 0}
# The ELL products (ops/sparse.py): "ell_mv" and "ell_rmv" count launches
# of ``csrc/ell_mv.cu`` on A's layout and on the transposed one, "plain"
# the products taken by the plain version (``sparse.ell_mv_ref``).
ELL_COUNTS = {"ell_mv": 0, "ell_rmv": 0, "plain": 0}

_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0
    LAUNCHES.clear()
    SCALAR_LAUNCHES.clear()
    for counter in (STORED, NONZERO, K1_PATH, ELL_COUNTS):
        for k in counter:
            counter[k] = 0


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
        "cannot build the banded kernels"
    )


def _run_all(cmds):
    """Run the commands together; raise with nvcc's output on a failure.
    Returns their stderr (ptxas's register and spill report)."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                "nvcc failed (exit {}): {}\n{}\n{}".format(p.returncode, " ".join(c), out, err)
            )
    return "".join(err for _, err in outs)


def build() -> tuple[float, str]:
    """Compile the kernel library if it is missing or older than a source.

    Returns (seconds spent, ptxas report); (0.0, "") when the library was
    current.  Raises RuntimeError with nvcc's output when the build fails.
    """
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= max(
        os.path.getmtime(s) for s in SOURCES + HEADERS
    ):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [
            os.path.join(tmp, os.path.basename(s)[:-3] + ".o") for s in SOURCES
        ]
        report = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(SOURCES, objs)]
        )
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        # atomic: a concurrent loader never sees half a file
        os.replace(lib, LIBRARY)
    return time.perf_counter() - t0, report


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(LIBRARY)
    # data, offsets (int32, device), nd, nrows, input, ne or lo, y, stream;
    # K1 and K2 then take the plan: vec, warps, cluster, stages, tile
    argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    for fn in (
        lib.porotpu_dia_mv_f32, lib.porotpu_dia_mv_f64,
        lib.porotpu_dia_rmv_f32, lib.porotpu_dia_rmv_f64,
    ):
        fn.argtypes = argtypes + [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    lib.porotpu_dia_mv_padded_f32.argtypes = argtypes
    lib.porotpu_dia_mv_padded_f32.restype = ctypes.c_int
    # ELL: data, cols (int32), n, width, x, n_in, y, stream
    for fn in (lib.porotpu_ell_mv_f32, lib.porotpu_ell_mv_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.porotpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.porotpu_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(name, data, offsets, x, dtypes):
    """Validate a launch's operands; returns (nd, nrows)."""
    if not (data.is_cuda and offsets.device == data.device and x.device == data.device):
        raise ValueError(f"{name}: data, offsets and the input must be on one CUDA device")
    if data.dtype not in dtypes or x.dtype != data.dtype:
        raise TypeError(
            f"{name}: needs data of {', '.join(map(str, dtypes))} and an input of the "
            f"same dtype, got {data.dtype} and {x.dtype}"
        )
    if offsets.dtype != torch.int32:
        raise TypeError(f"{name}: offsets must be int32, got {offsets.dtype}")
    if data.dim() != 2 or offsets.dim() != 1 or x.dim() != 1:
        raise ValueError(f"{name}: expects data (nd, nrows), offsets (nd,) and a 1-D input")
    nd, nrows = data.shape
    if offsets.shape[0] != nd:
        raise ValueError(f"{name}: {offsets.shape[0]} offsets for {nd} diagonals")
    if not (data.is_contiguous() and offsets.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: data, offsets and the input must be contiguous")
    if max(data.numel(), x.numel()) >= 2**31:
        raise ValueError(f"{name}: sizes beyond int32 indexing")
    return nd, nrows


def _launch(name, fn, data, offsets, nd, nrows, x, n, y, *plan_args):
    """One launch on the current stream; raises on the launch's CUDA error."""
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), offsets.data_ptr(), nd, nrows, x.data_ptr(), n,
                 y.data_ptr(), stream, *plan_args)
    if err != 0:
        raise RuntimeError(
            "{} launch failed: CUDA error {} ({})".format(
                name, err, _lib.porotpu_cuda_error_string(err).decode()
            )
        )
    COUNTS[name] += 1
    LAUNCHES[name, str(data.dtype).removeprefix("torch."), nd, nrows] += 1
    return y


# -- the launch plan of K1 and K2 ---------------------------------------------

SM_COUNT = 132  # NVIDIA H100 SXM
# Fixed by the kernels (csrc/dia_tile.cuh: kChunks, kStages), checked at
# each launch: 16-byte chunks a lane holds per diagonal, cp.async ring
# stages a warp.
CHUNKS = 2
STAGES = 2
WARPS = {torch.float32: 8, torch.float64: 4}  # warps of a block, one diagonal group each
MIN_WARPS_PER_SM = 12  # split over a cluster below this many warps an SM
MIN_DIAGONALS_PER_WARP = 4
SHARED_MEMORY_PER_BLOCK = 48 * 1024  # without a cudaFuncSetAttribute call


def smem_bytes(warps: int, tile: int, itemsize: int) -> int:
    """Dynamic shared memory of a K1/K2 block (csrc/dia_tile.cuh:
    smem_bytes): each warp's ring of STAGES stages of 2 * CHUNKS * 32 + 2
    16-byte chunks, then warps + 1 partial tiles."""
    return warps * STAGES * (2 * CHUNKS * 32 + 2) * 16 + (warps + 1) * tile * itemsize


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tile: int  # outputs a block owns: 32 lanes x CHUNKS x 16 bytes
    warps: int  # warps of a block, one diagonal group each
    cluster: int  # blocks on one tile: a thread-block cluster when > 1
    stages: int  # cp.async ring stages a warp
    blocks: int  # blocks of the grid
    vec: bool  # both lengths are whole 16-byte chunks
    smem_bytes: int  # dynamic shared memory of a block: rings, partial tiles

    @property
    def groups(self) -> int:
        return self.warps * self.cluster

    def group_ranges(self, nd: int) -> list[tuple[int, int]]:
        """The diagonals [lo, hi) of each group, split as the kernels split
        them (csrc/dia_tile.cuh: tile_and_group)."""
        g = self.groups
        return [(k * nd // g, (k + 1) * nd // g) for k in range(g)]


@functools.lru_cache(maxsize=1024)
def launch_plan(nd: int, n_out: int, n_in: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch of K1 (n_out = nrows, n_in = ne) or K2 (n_out = ne, n_in =
    nrows) over ``nd`` diagonals: one block of ``WARPS`` warps a tile of
    256 (f32) or 128 (f64) outputs, and the tile's diagonals split over a
    cluster of 2, 4 or 8 blocks while the grid has fewer than
    ``MIN_WARPS_PER_SM`` warps an SM and every warp keeps at least
    ``MIN_DIAGONALS_PER_WARP`` diagonals.  The 59136-row operators of the
    N=13 solve give 14 warps an SM unsplit, and time best so; the
    4480-row level-1 A takes a cluster of 8 (tools/dia_plan_sweep.py).
    Cached: the wrappers ask for it at every launch."""
    itemsize = dtype.itemsize
    per_chunk = 16 // itemsize
    tile = 32 * CHUNKS * per_chunk
    warps = WARPS[dtype]
    tiles = max(1, -(-n_out // tile))
    cluster = 1
    while (cluster < 8 and tiles * cluster * warps < MIN_WARPS_PER_SM * SM_COUNT
           and nd >= 2 * cluster * warps * MIN_DIAGONALS_PER_WARP):
        cluster *= 2
    return LaunchPlan(
        tile=tile, warps=warps, cluster=cluster, stages=STAGES, blocks=tiles * cluster,
        vec=n_out % per_chunk == 0 and n_in % per_chunk == 0,
        smem_bytes=smem_bytes(warps, tile, itemsize),
    )


@functools.lru_cache(maxsize=1024)
def launch_plan_like(nd: int, n_out: int, n_in: int, dtype: torch.dtype,
                     like_rows: int) -> LaunchPlan:
    """``launch_plan`` for K1 on (n_out, n_in) with the diagonal groups of a
    launch over ``like_rows`` outputs: its warps and cluster, so that each
    row is summed in that launch's order (a halo fix-up of a few rows
    against its slab's launch).  The shapes alone still decide the tiles
    and the vector path."""
    own, like = launch_plan(nd, n_out, n_in, dtype), launch_plan(nd, like_rows, n_in, dtype)
    return dataclasses.replace(own, warps=like.warps, cluster=like.cluster,
                               blocks=own.blocks // own.cluster * like.cluster,
                               smem_bytes=like.smem_bytes)


def _vector(plan, x) -> bool:
    """Whether a launch by ``plan`` on the input ``x`` takes 16-byte chunks:
    the plan allows them and x is 16-byte aligned (data must be)."""
    return plan.vec and x.data_ptr() % 16 == 0


def _launch_planned(name, fn, data, offsets, x, ne, y, plan):
    """Launch K1 or K2 by ``plan``, in 16-byte chunks where ``_vector``."""
    if data.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    nd, nrows = data.shape
    vec = _vector(plan, x)
    _launch(name, fn, data, offsets, nd, nrows, x, ne, y,
            int(vec), plan.warps, plan.cluster, plan.stages, plan.tile)
    if not vec:
        SCALAR_LAUNCHES[name, str(data.dtype).removeprefix("torch."), nd, nrows] += 1
    if name == "dia_mv":
        K1_PATH["vector" if vec else "scalar"] += nd * nrows
    return y


# -- K1 ----------------------------------------------------------------------


def dia_mv(data: torch.Tensor, offsets: torch.Tensor, xe: torch.Tensor,
           groups_of: int | None = None) -> torch.Tensor:
    """Launch K1: y (nrows,) with nrows = data.shape[1].

    data: (nd, nrows) float32/float64 CUDA tensor, 16-byte aligned;
    offsets: (nd,) int32 on the same device; xe: (ne,) of data's dtype, any
    ne >= 0.  ``groups_of``: split the diagonals as a launch over that
    many rows does (``launch_plan_like``).
    """
    nd, nrows = _check("dia_mv", data, offsets, xe, (torch.float32, torch.float64))
    y = torch.empty(nrows, dtype=data.dtype, device=data.device)
    if nrows == 0:
        return y
    if nd == 0:
        return y.zero_()
    lib = _load()
    fn = lib.porotpu_dia_mv_f32 if data.dtype == torch.float32 else lib.porotpu_dia_mv_f64
    ne = xe.shape[0]
    plan = (launch_plan(nd, nrows, ne, data.dtype) if groups_of is None
            else launch_plan_like(nd, nrows, ne, data.dtype, int(groups_of)))
    return _launch_planned("dia_mv", fn, data, offsets, xe, ne, y, plan)


# the rows of a plain product are summed over a width padded to a multiple
# of this: torch's CPU sum over the diagonals then takes every column in
# its 4-vector blocks (at most 4 x 16 values), one order for every row
SUM_WIDTH = 64


def dia_mv_ref(data: torch.Tensor, offsets, xe: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain PyTorch version of K1: a gather of shifted windows of the
    zero-padded input, summed over the diagonals.  The padding is
    porotpu's ``DIA._pads`` (porotpu/ops/dia.py:294-299).  The products
    are summed over a width of whole ``SUM_WIDTH`` blocks, so that on the
    CPU a row's sum does not depend on how many rows are computed with
    it: a few rows (a halo fix-up) equal those rows of the whole product
    bit for bit.

    ``offsets``: sequence of ints (or an int tensor) of length nd.
    """
    offs = torch.as_tensor(offsets, dtype=torch.int64).cpu()
    ne = xe.shape[0]
    if offs.numel() == 0 or nrows == 0:
        return torch.zeros(nrows, dtype=xe.dtype, device=xe.device)
    lo = max(0, -int(offs.min()))
    hi = max(0, nrows - 1 + int(offs.max()) - (ne - 1))
    xpad = F.pad(xe, (lo, hi))
    windows = xpad.unfold(0, nrows, 1)  # windows[s] = xpad[s : s + nrows]
    prod = data * windows[(offs + lo).to(xe.device)]
    pad = -nrows % SUM_WIDTH
    return (F.pad(prod, (0, pad)) if pad else prod).sum(0)[:nrows]


def mv(data, offsets, offsets_dev, xe, nrows, groups_of=None, nnz=None):
    """Banded product dispatched by device: K1 for a CUDA tensor, its plain
    version for a CPU tensor.  ``groups_of``: K1's diagonal groups as a
    launch over that many rows (``dia_mv``); ``nnz``: the structural
    nonzeros of ``data``, for ``STORED``/``NONZERO``."""
    nd = data.shape[0]
    if nnz is not None:
        STORED["dia_mv"] += nd * nrows
        NONZERO["dia_mv"] += nnz
    if xe.is_cuda:
        return dia_mv(data, offsets_dev, xe, groups_of)  # K1_PATH counted at the launch
    COUNTS["plain"] += 1
    if nd and nrows:
        vec = _vector(launch_plan(nd, nrows, xe.shape[0], data.dtype), xe)
        K1_PATH["vector" if vec else "scalar"] += nd * nrows
    return dia_mv_ref(data, offsets, xe, nrows)


# -- K2 ----------------------------------------------------------------------


def dia_rmv(data: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor, ne: int) -> torch.Tensor:
    """Launch K2: y (ne,) over the embedded column space.

    data: (nd, nrows) float32/float64 CUDA tensor, 16-byte aligned;
    offsets: (nd,) int32 on the same device; x: (nrows,) of data's dtype;
    ne >= 0.
    """
    nd, nrows = _check("dia_rmv", data, offsets, x, (torch.float32, torch.float64))
    if x.shape[0] != nrows:
        raise ValueError(f"dia_rmv: input of length {x.shape[0]} for {nrows} rows")
    if not 0 <= ne < 2**31:
        raise ValueError(f"dia_rmv: output length {ne} outside int32")
    y = torch.empty(ne, dtype=data.dtype, device=data.device)
    if ne == 0:
        return y
    if nd == 0 or nrows == 0:
        return y.zero_()
    lib = _load()
    fn = lib.porotpu_dia_rmv_f32 if data.dtype == torch.float32 else lib.porotpu_dia_rmv_f64
    return _launch_planned("dia_rmv", fn, data, offsets, x, ne, y,
                           launch_plan(nd, ne, nrows, data.dtype))


def dia_rmv_ref(data: torch.Tensor, offsets, x: torch.Tensor, ne: int) -> torch.Tensor:
    """Plain PyTorch version of K2: y[k] = sum_d dpad[d, plo - o_d + k] with
    dpad the zero-padded product data * x (porotpu/ops/dia.py:579-594)."""
    offs = [int(o) for o in offsets]
    nrows = data.shape[1]
    if not offs or ne == 0 or nrows == 0:
        return torch.zeros(ne, dtype=x.dtype, device=x.device)
    plo = max(max(offs), 0)
    phi = max(0, ne - min(offs) - nrows)
    prod = F.pad(data * x, (plo, phi))
    starts = plo - torch.tensor(offs, dtype=torch.int64, device=x.device)
    idx = starts[:, None] + torch.arange(ne, device=x.device)[None, :]
    return torch.gather(prod, 1, idx).sum(0)


def rmv(data, offsets, offsets_dev, x, ne, nnz=None):
    """Transpose product dispatched by device: K2 for a CUDA tensor, its
    plain version for a CPU tensor.  ``nnz`` as for ``mv``."""
    if nnz is not None and ne:
        STORED["dia_rmv"] += data.numel()
        NONZERO["dia_rmv"] += nnz
    if x.is_cuda:
        return dia_rmv(data, offsets_dev, x, ne)
    COUNTS["plain"] += 1
    return dia_rmv_ref(data, offsets, x, ne)


# -- K3 ----------------------------------------------------------------------


def pads(offsets) -> tuple[int, int]:
    """(lo, hi): the zeros K3's input carries before and after x."""
    return max(0, -min(offsets)), max(0, max(offsets))


def dia_mv_padded(data: torch.Tensor, offsets, offsets_dev: torch.Tensor,
                  xpad: torch.Tensor) -> torch.Tensor:
    """Launch K3: y (nrows,) with nrows = data.shape[1].

    data: (nd, nrows) float32 CUDA tensor; ``offsets``: the nd offsets as
    ints, and ``offsets_dev`` the same as an (nd,) int32 tensor on the
    card; xpad: (lo + nrows + hi,) float32 with (lo, hi) = ``pads(offsets)``.
    """
    nd, nrows = _check("dia_mv_padded", data, offsets_dev, xpad, (torch.float32,))
    if nd > MAX_DIAGONALS:
        raise ValueError(f"dia_mv_padded: {nd} diagonals exceed the {MAX_DIAGONALS} staged")
    if len(offsets) != nd:
        raise ValueError(f"dia_mv_padded: {len(offsets)} host offsets for {nd} diagonals")
    lo, hi = pads(offsets) if nd else (0, 0)
    if xpad.shape[0] != lo + nrows + hi:
        raise ValueError(
            f"dia_mv_padded: xpad has {xpad.shape[0]} values, the offsets need "
            f"{lo} + {nrows} + {hi}"
        )
    y = torch.empty(nrows, dtype=data.dtype, device=data.device)
    if nrows == 0:
        return y
    if nd == 0:
        return y.zero_()
    lib = _load()
    return _launch("dia_mv_padded", lib.porotpu_dia_mv_padded_f32, data, offsets_dev,
                   nd, nrows, xpad, lo, y)


def dia_mv_padded_ref(data: torch.Tensor, offsets, xpad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: the windows xpad[lo + o_d : lo + o_d +
    nrows] (an ``unfold`` of xpad), weighted by the diagonals and summed."""
    nd, nrows = data.shape
    if nd == 0 or nrows == 0:
        return torch.zeros(nrows, dtype=xpad.dtype, device=xpad.device)
    lo, _ = pads(offsets)
    windows = xpad.unfold(0, nrows, 1)  # windows[s] = xpad[s : s + nrows]
    idx = torch.as_tensor(offsets, dtype=torch.int64, device=xpad.device) + lo
    return (data * windows[idx]).sum(0)

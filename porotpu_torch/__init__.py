"""porotpu_torch — the PyTorch/CUDA port of ``porotpu`` for one NVIDIA H100.

Same layout and names as ``porotpu``: ``fem`` (meshes, Lagrange spaces,
assembly, Dirichlet BCs), ``ops`` (banded storage and the hand-written
CUDA kernels), ``solvers`` (FGMRES and the field-wise convergence test),
``precond`` (AMG, inner solvers, Schur fieldsplit, 2-way block
preconditioner), ``models`` (forms, loads, the poromechanics problem and
swelling-3d) and ``tools`` (the banded-matvec microbench).  ``convert``
carries porotpu's device objects across for the parity tests.

The port imports torch, numpy and scipy, and nothing named ``porotpu``:
the host modules it shares with porotpu (``fem``, ``models.{forms,
loads,abstract}``) are copies, each naming its source on its first line.
The entry points run on the card unless the caller passes ``device="cpu"``.
"""


def _tune_host_allocator():
    """Keep large malloc arenas resident (first-touch page faults are ~100x
    more expensive than warm access in the microVM environments this runs
    in; without this, every large numpy temporary re-faults its pages).

    Equivalent to MALLOC_MMAP_THRESHOLD_/MALLOC_TRIM_THRESHOLD_ env vars,
    but applied at import time via mallopt(3).  Copy of
    porotpu/__init__.py:_tune_host_allocator.
    """
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):  # no glibc: keep the default allocator
        pass


_tune_host_allocator()

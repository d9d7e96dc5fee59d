# Copy of porotpu/utils/cache.py for the port's solver state: nn.Modules pickled with CPU tensors.
"""Solver-state caching: pickle the fully built solver state to disk.

Setup (assembly, AMG hierarchies, factorizations) is host-bound and can
dwarf the solve; production use is "set up once, solve many steps or
configurations".  These helpers pickle the solver state (the operator and
preconditioner modules with their CPU tensors, the BC arrays) and restore
it without running any host setup.

The port's files are its own: their schema names the port, and a caller
gives them names that porotpu's never take, so that neither package
unpickles the other's state (unpickling porotpu's imports jax).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading


def config_key(**kwargs) -> str:
    """Stable hash key for a cache entry."""
    blob = repr(sorted(kwargs.items())).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


# Bump whenever a cached module's layout changes (DIA, ELL, AMG, PC
# classes).  A cache written under another schema misses and rebuilds.
# torch-2: ELL holds its transposed layout (dataT, colsT).
# torch-3: ELL stores int32 column indices.
SCHEMA = "torch-3"


def _tmp_name(path: str) -> str:
    # unique per writer: two concurrent saves to one path must not
    # interleave into one tmp file
    return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"


def _dumps(state) -> bytes:
    return pickle.dumps({"schema": SCHEMA, "tree": state}, protocol=4)


def _write(path: str, blob: bytes):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = _tmp_name(path)
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)


def save(path: str, state):
    """Pickle ``state`` (modules and tensors on the CPU) to ``path``."""
    _write(path, _dumps(state))


def save_async(path: str, state):
    """Serialise now, write the bytes in the background.

    The pickle is taken on the calling thread, so a later ``.to(device)``
    of the same modules (which swaps their buffers in place) cannot race
    it; only the disk write leaves the setup's critical path.  The
    tmp+rename protocol keeps the file whole: an interrupted write leaves
    the previous cache or nothing, and ``load`` tolerates corruption
    anyway.  The writer joins at interpreter exit.  Returns the thread.
    """
    import atexit

    blob = _dumps(state)

    def _run():
        try:
            _write(path, blob)
        except OSError:  # a failed cache write must never break the run
            pass

    t = threading.Thread(target=_run, name="porotpu-torch-cache-save", daemon=False)
    t.start()
    atexit.register(t.join)
    return t


def load(path: str):
    """The cached state on the CPU; None on a miss, a stale schema or ANY
    corruption: a cache can only ever cause a rebuild, never a crash."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        if not isinstance(blob, dict) or blob.get("schema") != SCHEMA:
            return None
        return blob["tree"]
    except Exception:
        return None

"""The yardstick's peaks and the bytes a product has to move.

Bytes are counted from the operator's own shapes, whatever kernel
computes the product, so a later kernel's share reads the same work: each
stored value, each index, each input and each output element once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def dia_bytes(nd: int, nrows: int, n_in: int, n_out: int, itemsize: int) -> int:
    """A banded product from its (nd, nrows) stored diagonals: the stored
    values, the input (n_in) and the output (n_out).  For A x (K1) n_in is
    the embedded input length and n_out = nrows; for A^T x (K2) n_in = nrows
    and n_out the embedded output length."""
    return (nd * nrows + n_in + n_out) * itemsize


def ell_bytes(rows: int, width: int, n_in: int, itemsize: int, index_size: int = 8) -> int:
    """A padded-row (ELL) product: rows x width values and column indices,
    the input (n_in) and the output (rows)."""
    return rows * width * (itemsize + index_size) + (n_in + rows) * itemsize


def share(nbytes: float, seconds: float) -> float | None:
    """Percent of the bandwidth roofline: the least time the bytes need at
    the peak over the time taken; None when nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds

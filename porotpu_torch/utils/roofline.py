"""Device timing for the roofline line on the card (porotpu/utils/roofline.py).

The stream peak is the rate of a chained triad ``y = s*x + y`` over arrays
of ``mb`` MB (each rep reads x and y and writes y: three arrays), and an
operator's product time is that of a chain of products whose output,
renormalized, is the next input.  Both take the per-rep time as the R2-R1
delta of two chains, so the fixed costs (the events, the first launch)
cancel.  Times are CUDA events around a chain queued behind a sleep of
the stream, so the host has queued every rep before the first runs and
the events time the device alone.  L2 state: the triad's arrays are each
five times the H100's 50 MB L2, so every rep streams from device memory;
the product chain is warm, as a solve's repeated products find it.
"""

from __future__ import annotations

import torch

# device cycles the stream sleeps before a timed chain (about 60 ms on an
# H100): longer than the host takes to queue the longest chain here
SLEEP_CYCLES = 100_000_000


def _require_card(device):
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"roofline: times the card, and {device} is not a CUDA card")
    return device


def pattern(n, dtype, device, seed=0):
    """Deterministic stream data made on the device (porotpu's pattern)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (((i * (1103 + seed)) % 1009).to(dtype) - 504.0) * 1e-3


def _chain_ms(step, reps, device):
    """Milliseconds of ``reps`` calls of ``step`` back to back, device time."""
    step()  # warm-up
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def delta_seconds(step, R1, R2, device, trials=3):
    """Seconds per call of ``step`` by the R2-R1 delta, each chain the
    fastest of ``trials``."""
    t1 = min(_chain_ms(step, R1, device) for _ in range(trials))
    t2 = min(_chain_ms(step, R2, device) for _ in range(trials))
    return max((t2 - t1) / (R2 - R1), 1e-9) / 1e3


def stream_peak(dtype, mb=256, device="cuda"):
    """Device-memory streaming peak in GB/s: a chained triad over ``mb`` MB
    arrays, 3 arrays a rep."""
    device = _require_card(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = int(mb * 1e6 / itemsize)
    x = pattern(n, dtype, device)
    y = torch.zeros_like(x)
    i = [0]

    def triad():
        i[0] += 1
        y.add_(x, alpha=1.0 + 1e-7 * i[0])

    t = delta_seconds(triad, 5, 55, device)
    return 3 * n * itemsize / t / 1e9


def op_stream_time(A, b, R1=3, R2=23):
    """Seconds per product of operator ``A`` (``A.matvec``) on ``b``'s card,
    chained: each output, scaled by 1 + max|z|, is the next input (one cheap
    pass over the vector, charged to the product)."""
    device = _require_card(b.device)
    y = b.clone()

    @torch.inference_mode()
    def step():
        z = A.matvec(y)
        y.copy_(z / (1.0 + z.abs().max()))

    return delta_seconds(step, R1, R2, device)


def padded_values(op) -> int:
    """Values an operator stores and streams a product (porotpu's
    ``nnz_padded``): a FieldMatrix sums its blocks, a Transposed block
    counts its inner's, DIA, Dense and ELL their ``data``."""
    name = type(op).__name__
    if name == "FieldMatrix":
        return sum(padded_values(blk) for blk in op.blocks.values())
    if name == "Transposed":
        return padded_values(op.inner)
    return op.data.numel()

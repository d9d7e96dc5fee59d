#!/usr/bin/env python3
"""Banded-matvec microbench on the card: kernel K3 on a pre-padded input,
beside K1 on the same data and cuSPARSE.

    python3 -m porotpu_torch.tools.dia_microbench

Counterpart of tools/pallas_dia.py:main.  The same problem: n = 98304
rows, nd = 233 diagonals with offsets range(-116, 117), the ``_pattern``
data and input, f32.  K3 (``dia_kernel.dia_mv_padded``) reads x
zero-padded by lo = 116 before and hi = 116 after, with no bounds test;
K1 (``dia_kernel.dia_mv``) reads the unpadded x through its per-diagonal
mask;
the library call is ``A @ x`` on a torch sparse CSR tensor (cuSPARSE),
a yardstick only.  All three are checked against the numpy reference to
1e-5 of max|y|, and K3 against its plain version and against K1.

Each is timed two ways with CUDA events: per launch on one input, and as
a chain of steps in which y / (1 + max|y|) is written back into the input
(into the interior of xpad for K3), as the TPU prototype timed it.  The
routes take turns (K3, K1, cuSPARSE, cuSPARSE, K1, K3) and each keeps the
faster of its two turns.  The
bound is the bytes the product must move (data, input and output, each
once) over the H100's 3.35 TB/s (data sheet), and again over the f32
stream peak measured on the card (``utils/roofline.stream_peak``): each
share is printed against both.
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from ..ops import dia_kernel
from ..utils.roofline import stream_peak

# NVIDIA H100 SXM data sheet: HBM3 rate, and the peak rates outside the
# tensor cores (the banded products do one multiply-add per stored value)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# timed calls per launch measurement, and steps per chained measurement
REPS = 50
STEPS = 20
# bytes read between two cold launches: twice the H100's 50 MB L2
FLUSH_BYTES = 100 * 2**20


def bound(nbytes, flops, dtype, bytes_per_s=HBM_BYTES_PER_S):
    """(ms, "bytes" or "operations"): the least time the H100 could take to
    move ``nbytes`` at ``bytes_per_s`` (the data sheet's rate unless given)
    and do ``flops`` of ``dtype``, and which of the two bounds it."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shares(ms, nbytes, flops, dtype, peak_gbps):
    """A time's share of its bound, against the data sheet and against the
    stream peak ``peak_gbps`` measured on this card (utils/roofline.py)."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    m_ms, m_by = bound(nbytes, flops, dtype, peak_gbps * 1e9)
    return (f"{100 * b_ms / ms:.1f}% of the {b_by} bound {b_ms:.4f} ms (data sheet), "
            f"{100 * m_ms / ms:.1f}% of the {m_by} bound {m_ms:.4f} ms (measured peak "
            f"{peak_gbps:.0f} GB/s)")


def band_entries(offsets, nrows, ncols):
    """Stored values of an (nrows, ncols) banded matrix that lie inside it:
    the values a product must read."""
    return sum(max(0, min(nrows, ncols - o) - max(0, -o)) for o in offsets)


def banded_csr(data, offsets, ncols, transpose=False):
    """The (nrows, ncols) banded matrix A[i, i + o_d] = data[d, i] as a torch
    sparse CSR tensor on data's device, or its transpose.  Columns are
    sorted within each row."""
    nd, nrows = data.shape
    dev = data.device
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
    if transpose:
        # row j of A^T holds data[d, j - o_d]; descending d sorts its columns
        d_desc = torch.arange(nd - 1, -1, -1, device=dev)
        src = torch.arange(ncols, device=dev)[:, None] - offs[d_desc][None, :]
        ok = (src >= 0) & (src < nrows)
        vals = data[d_desc[None, :].expand_as(src)[ok], src[ok]]
        cols, shape = src[ok], (ncols, nrows)
    else:
        dst = torch.arange(nrows, device=dev)[:, None] + offs[None, :]
        ok = (dst >= 0) & (dst < ncols)
        vals = data.t()[ok]
        cols, shape = dst[ok], (nrows, ncols)
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=dev)
    crow[1:] = ok.sum(1).cumsum(0)
    with warnings.catch_warnings():  # torch marks its sparse CSR support beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals, shape, check_invariants=False)


# device cycles the stream sleeps before a timed loop, so that the host has
# queued every call before the first runs (about 10 ms on an H100): the
# events then time the device alone, not the host's launch overhead
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn over ``reps`` calls back to back,
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps):
    """Mean milliseconds per call of fn with the L2 cache flushed before
    each call, CUDA events around the call alone, after one warm-up call.
    The flush reads FLUSH_BYTES: a write would leave the L2 full of dirty
    lines, whose write-back the timed call would pay."""
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


# The ELL operators of the benchmark's cells, (rows, width, input length):
# footing's level-0 P, its level-1 A, a level-1 P^T, the Schur operator's
# rows, a coupling block; the 3D cell's level-0 P and its stored P^T
ELL_SHAPES = ((14818, 48, 3688), (7552, 306, 7552), (3688, 306, 14818), (1884, 50, 1884),
              (14818, 9, 14818), (206763, 90, 16422), (16422, 741, 206763))


def random_ell(n, width, n_in, seed=0):
    """(data f64 (n, width), cols int32 (n, width)): an ELL over n_in
    columns whose row lengths are drawn from [0, width] (row 0 full, row 1
    empty), each row's columns sorted in a window of 4 x width around
    i * n_in / n, as an assembled operator's lie; a pad slot holds zero and
    its row's first column (``ops/sparse.py:_ell_arrays``)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, width + 1, size=n)
    counts[: min(n, 2)] = (width, 0)[: min(n, 2)]
    span = min(n_in, 4 * width)
    start = np.clip(np.arange(n) * n_in // n - span // 2, 0, n_in - span)
    cols = start[:, None] + np.sort(rng.integers(0, span, size=(n, width)), axis=1)
    pad = np.arange(width)[None, :] >= counts[:, None]
    data = np.where(pad, 0.0, rng.normal(size=(n, width)))
    return data, np.where(pad, cols[:, :1], cols).astype(np.int32)


def _pattern(n, seed=0):
    """tools/pallas_dia.py:_pattern in numpy (int32 products wrap alike)."""
    i = np.arange(n, dtype=np.int32)
    return (((i * np.int32(1103 + seed)) % 1009).astype(np.float32) - 504.0) * np.float32(1e-3)


def run(n=98304, nd=233, peak_gbps=None):
    """Check and time K3, K1 and cuSPARSE on card 0; returns the record.
    Shares are taken against the f32 stream peak ``peak_gbps``, measured
    here when None."""
    if not torch.cuda.is_available():
        raise RuntimeError("dia_microbench measures the card: it needs a CUDA device")
    dev = torch.device("cuda", 0)
    half = nd // 2
    offsets = tuple(range(-half, nd - half))
    lo, hi = dia_kernel.pads(offsets)

    data_np = _pattern(nd * n, seed=1).reshape(nd, n) / np.float32(nd)
    x_np = _pattern(n, seed=2)
    xp = np.concatenate([np.zeros(lo), x_np, np.zeros(hi)])
    y_ref = np.zeros(n)
    for d, o in enumerate(offsets):
        y_ref += data_np[d] * xp[lo + o : lo + o + n]

    data = torch.from_numpy(data_np).to(dev)
    offs_dev = torch.tensor(offsets, dtype=torch.int32, device=dev)
    xpad = torch.from_numpy(xp.astype(np.float32)).to(dev)
    x = xpad[lo : lo + n].clone()
    A = banded_csr(data, offsets, n)

    routes = {
        "k3": lambda xp_, x_: dia_kernel.dia_mv_padded(data, offsets, offs_dev, xp_),
        "k1": lambda xp_, x_: dia_kernel.dia_mv(data, offs_dev, x_),
        "cusparse": lambda xp_, x_: A @ x_,
    }
    ys = {k: f(xpad, x) for k, f in routes.items()}
    y_plain = dia_kernel.dia_mv_padded_ref(data, offsets, xpad)
    torch.cuda.synchronize()
    ref_max = np.abs(y_ref).max()
    errs = {k: float(np.abs(y.cpu().numpy() - y_ref).max() / ref_max) for k, y in ys.items()}
    errs["k3_vs_plain"] = float((ys["k3"] - y_plain).abs().max() / y_plain.abs().max())
    errs["k3_vs_k1"] = float((ys["k3"] - ys["k1"]).abs().max() / ys["k1"].abs().max())
    abs_err = float((ys["k3"] - y_plain).abs().max())
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    if bad:
        raise RuntimeError(f"dia_microbench: errors above 1e-5 of max|y|: {bad}")

    # bytes each product must move: data, input, output, each once
    entries = band_entries(offsets, n, n)
    nbytes = {
        "k3": (nd * n + (lo + n + hi) + n) * 4,
        "k1": (entries + 2 * n) * 4,
        "cusparse": (entries + 2 * n) * 4,
    }
    def chain(k):
        """One chained step of route k: the product, scaled, written back."""
        f, xp_c, x_c = routes[k], xpad.clone(), x.clone()

        def step():
            y = f(xp_c, x_c)
            y = y / (1.0 + y.abs().max())
            if k == "k3":
                xp_c[lo : lo + n] = y
            else:
                x_c.copy_(y)

        return step

    # the routes are timed in turns, forward then backward, so that no
    # route always runs first; each keeps the faster of its two turns
    turns = {k: [] for k in routes}
    for k in list(routes) + list(routes)[::-1]:
        f = routes[k]
        turns[k].append((cuda_ms(lambda: f(xpad, x), REPS), cuda_ms(chain(k), STEPS)))
    out = {"n": n, "nd": nd, "errors": errs, "max_abs_err": abs_err}
    for k in routes:
        ms, chain_ms = min(t[0] for t in turns[k]), min(t[1] for t in turns[k])
        flops = 2 * (nd * n if k == "k3" else entries)
        b_ms, b_by = bound(nbytes[k], flops, torch.float32)
        out[k] = {
            "ms": ms, "turns_ms": [t[0] for t in turns[k]], "chain_ms": chain_ms,
            "gbps": nbytes[k] / ms / 1e6, "bound_ms": b_ms, "bound_by": b_by,
            "nbytes": nbytes[k], "flops": flops,
        }
    out["plain_ms"] = cuda_ms(lambda: dia_kernel.dia_mv_padded_ref(data, offsets, xpad), 5)
    out["stream_peak_gbps"] = (stream_peak(torch.float32, device=dev) if peak_gbps is None
                               else peak_gbps)
    return out


def report(rec):
    """Print a record of ``run``, one line a route."""
    names = {"k3": "K3 dia_mv_padded (pre-padded x)", "k1": "K1 dia_mv (masked x)",
             "cusparse": "cuSPARSE CSR A @ x"}
    print(f"dia_microbench n={rec['n']} nd={rec['nd']} f32; errors vs the numpy "
          "reference / plain / K1: " + ", ".join(f"{k} {e:.2e}" for k, e in rec["errors"].items()))
    for k, name in names.items():
        r = rec[k]
        turns = "/".join(f"{t:.4f}" for t in r["turns_ms"])
        share = shares(r["ms"], r["nbytes"], r["flops"], torch.float32, rec["stream_peak_gbps"])
        print(f"  {name}: {r['ms']:.4f} ms per launch (turns {turns}) = {r['gbps']:.0f} GB/s "
              f"= {share}; chained step {r['chain_ms']:.4f} ms")
    print(f"  plain version of K3 (unfold): {rec['plain_ms']:.4f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("dia_microbench: needs a CUDA card", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    report(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())

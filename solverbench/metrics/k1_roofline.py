"""k1_roofline: the bytes of every K1 product in the traced steps (stored
diagonals, input, output; roofline.dia_bytes) over the device time of
the dia_mv_kernel launches, against the peak bandwidth, in percent.
The bytes are the counted calls' mean times the launches the
trace holds, which are all of them unless the profiler dropped records."""

from solverbench.roofline import share


def read(run):
    tr, pr = run.trace, run.products
    if tr is None or pr is None or not tr.k1_launches or not pr.k1_calls:
        return None
    return share(pr.k1_bytes * tr.k1_launches / pr.k1_calls, tr.k1_s)

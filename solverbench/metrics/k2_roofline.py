"""k2_roofline: the bytes of every K2 product (f64 banded transposes) in
the traced steps over the device time of the dia_rmv_kernel launches,
against the peak bandwidth, in percent.  The bytes are the counted
calls' mean times the launches the trace holds."""

from solverbench.roofline import share


def read(run):
    tr, pr = run.trace, run.products
    if tr is None or pr is None or not tr.k2_launches or not pr.k2_calls:
        return None
    return share(pr.k2_bytes * tr.k2_launches / pr.k2_calls, tr.k2_s)

"""ell_roofline: the bytes of every ELL product in the traced steps
(values, column indices, input, output; roofline.ell_bytes) over the
device time of the kernels launched inside the solverbench.ell spans the
harness puts around them, against the peak bandwidth, in percent.  The
bytes are the counted products' mean times the spans the trace holds."""

from solverbench.roofline import share


def read(run):
    tr, pr = run.trace, run.products
    if tr is None or pr is None or not pr.ell_calls or tr.ell_s <= 0:
        return None
    return share(pr.ell_bytes * tr.ell_spans / pr.ell_calls, tr.ell_s)

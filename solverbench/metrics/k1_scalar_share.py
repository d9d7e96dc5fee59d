"""k1_scalar_share: of the diagonal values that the run's K1 products
streamed, the share launched on K1's scalar path (a length that is not a
whole number of 16-byte chunks, or an unaligned input), in percent.  It
reads the port's always-on counter (``porotpu_torch.ops.dia_kernel``'s
``K1_PATH``, summed by ``porotpu_torch.utils.trace.banded_totals``) over
the whole run: set-up, warm step, window and traced steps.  None where
the port keeps no such counter."""


def read(run):
    from porotpu_torch.utils import trace

    totals = getattr(trace, "banded_totals", None)
    return totals().k1_scalar_share if totals is not None else None

"""dia_fill: of the diagonal values that the run's K1 and K2 products
streamed, the share that are structural zeros, in percent.  It reads the
port's always-on counters (``porotpu_torch.ops.dia_kernel``'s ``STORED``
and ``NONZERO``, summed by ``porotpu_torch.utils.trace.banded_totals``)
over the whole run: set-up, warm step, window and traced steps.  None
where the port keeps no such counter."""


def read(run):
    from porotpu_torch.utils import trace

    totals = getattr(trace, "banded_totals", None)
    return totals().fill if totals is not None else None

"""rhs_ms: the mean host time of a window step's get_rhs (host load
assembly, the history products, the copy to the device), with a
synchronize on each side, in milliseconds."""


def read(run):
    return 1e3 * sum(run.rhs_s) / len(run.rhs_s) if run.rhs_s else None

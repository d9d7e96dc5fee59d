"""launches_per_step: device kernels in the profiler's trace of the traced
steps, over the steps (copies and fills not counted)."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.trace.kernels:
        return None
    return run.trace.kernels / run.traced_steps

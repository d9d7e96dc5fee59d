"""iters_per_step: the outer solver's iterations over the window's steps
(the port's iteration_log, as solve_time_step returns it)."""


def read(run):
    return sum(s.iters for s in run.steps) / len(run.steps) if run.steps else None

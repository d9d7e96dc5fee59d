"""step_s: the wall time of the whole measured window over the whole time
steps in it (each step ends in the solve's synchronize)."""


def read(run):
    return run.step_s()

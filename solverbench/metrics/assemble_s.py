"""assemble_s: host clock around the driver's setup(): mesh, spaces, FE
assembly of the blocks (drivers/*.setup, models/benchmarks.py, fem/)."""


def read(run):
    return run.assemble_s

"""pc_setup_s: host clock around create_solver(), which synchronizes:
operators and block PC built on the host (precond/, AMG), moved to the
device."""


def read(run):
    return run.pc_setup_s

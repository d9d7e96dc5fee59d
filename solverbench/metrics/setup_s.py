"""setup_s: process start to the end of the warm step: imports, CUDA
init, the kernel library's load (its build in a first run), the driver's
setup(), create_solver() and one time step."""


def read(run):
    return run.setup_s

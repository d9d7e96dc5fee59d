"""2D footing consolidation benchmark driver on the port (the counterpart of footing.py).

    python -m porotpu_torch.drivers.footing -N 10 [--pc-type "undrained"] [--petsc-options FILE] [--device cpu]

Same flags and defaults as footing.py (``utils.parser``), f64 unless
``--dtype`` says otherwise, and the same "Solved time t=... N iterations"
lines.  It runs on the card and raises without one, unless
``--device cpu`` is passed.
"""

from porotpu_torch.models import benchmarks
from porotpu_torch.utils.parser import Parser


def setup(argv=None, overrides=None):
    """The problem the command line asks for, built but not solved;
    ``overrides`` updates the driver's parameters before the flags do."""
    parser = Parser(argv)
    N = parser.options.N or 10
    refinements = parser.options.refinements or 0
    return benchmarks.footing(N, refinements, parser=parser, overrides=overrides,
                              device=parser.options.device)


def main(argv=None):
    problem = setup(argv)
    problem.solve()
    problem.print_timings()
    return problem


if __name__ == "__main__":
    main()

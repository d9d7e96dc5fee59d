"""2D swelling benchmark driver on the port (the counterpart of swelling.py).

    python -m porotpu_torch.drivers.swelling -N 10 [--pc-type "diagonal"] [--petsc-options FILE] [--device cpu]

Same flags and defaults as swelling.py (``utils.parser``), f64 unless
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
    return benchmarks.swelling(N, refinements, parser=parser, overrides=overrides,
                               device=parser.options.device)


def main(argv=None):
    problem = setup(argv)
    problem.solve()
    problem.print_timings()
    return problem


if __name__ == "__main__":
    main()

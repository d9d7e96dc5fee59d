"""See the package docstring of porotpu_torch."""

from .aar import aar
from .anderson import AndersonAccelerator, AndersonState
from .basic import preonly, richardson
from .cg import cg
from .chebyshev import chebyshev, estimate_spectrum
from .gmres import fgmres, gmres
from .result import SolveResult

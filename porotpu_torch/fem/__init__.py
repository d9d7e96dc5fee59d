# Copy of porotpu/fem/__init__.py, behaviour unchanged.
from .mesh import (
    Mesh,
    generate_square,
    generate_rectangle,
    generate_cube,
    generate_footing_square,
    generate_boundary_measure,
    NONE,
)
from .dofmap import FunctionSpace, MixedSpace
from .bcs import DirichletBC

"""See the package docstring of porotpu_torch."""

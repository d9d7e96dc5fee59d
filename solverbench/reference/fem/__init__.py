"""The host FE library the plain reference assembles with: a frozen copy of
the port's ``porotpu_torch/fem`` (mesh, elements, quadrature, dofmap,
assembly, Dirichlet rows), importing nothing of the port."""

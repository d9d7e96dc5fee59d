"""The plain reference: NumPy/SciPy only, importing nothing of the port.

``fem/`` is a frozen copy of the port's host FE library; ``system.py``
assembles the 3-field operator and each step's right-hand side from it;
``footing2d.py`` and ``swelling2d.py`` state the two published problems
(mesh, materials, loads, Dirichlet conditions), from the upstream drivers.
"""

"""solverbench: the benchmark of the PyTorch/CUDA port ``porotpu_torch``.

``run.py`` runs one cell of ``BENCHMARK.json``; everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own
(``configs/``, ``traffic/``, ``metrics/``), found by name.  ``reference/``
is the plain NumPy/SciPy reference that decides ``correct``.
"""

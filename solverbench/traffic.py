"""The one generator of a cell's inputs, from its traffic file and the seed.

A traffic file (``traffic/<name>.json``) gives the solver's options
file and PC type, the number of whole time steps the window runs
(``steps``: the same work whatever the speed, as the solver's iterations
change along a trajectory), optionally further driver flags (``args``, a
list) and driver parameters (``parameters``, a dict; a configuration file
may carry both too), optionally the limits of ``check``'s numbers where
they are not the configuration's (``limits``: an outer solver that
reports another residual than the field-wise one is held to ``resid_q``
alone), and the ranges the seed draws from:

- ``t0``: [lo, hi], the time the run starts from (zero state), drawn on
  the grid of ``t0_step`` (a whole number of steps from lo);
- ``load_factor``: [lo, hi], one factor on every surface load of the
  problem.  One factor scales the whole trajectory from the zero state, so
  every seed asks for the same iterations: a factor of its own on each
  load changes their mix, and with it the work (swelling's 3-way solve
  took 3 iterations a step instead of 5 with 0.7 and 1.5 on its two).

The same seed gives the same inputs; the port's own loads are scaled by
the factor, and the reference builds its loads from the same factor.
"""

from __future__ import annotations

import numpy as np


def draw(traffic: dict, seed: int, slots) -> tuple[float, dict]:
    """(t0, {load slot: factor}) for ``seed``."""
    rng = np.random.default_rng(int(seed))
    lo, hi = (float(v) for v in traffic["t0"])
    step = float(traffic.get("t0_step", 0.0))
    if step > 0:
        t0 = lo + step * int(rng.integers(0, int(round((hi - lo) / step)) + 1))
    else:
        t0 = float(rng.uniform(lo, hi))
    flo, fhi = (float(v) for v in traffic["load_factor"])
    factor = float(rng.uniform(flo, fhi))
    return t0, {slot: factor for slot in slots}

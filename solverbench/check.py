"""The comparison that decides ``correct``: every step the port took is
judged by the plain reference.

A step's answer is its solution x_k and its claim: converged, with the
field-wise residual r = max over fields of ||b_k - A x_k||_inf (the
solver's own test, upstream lib/Solver.py:8-51).  The reference builds
A and b_k itself (``reference.system``), b_k from the port's two previous
solutions, as the port's time update hands them on, and reads two numbers
a step:

- ``resid_q``: the configuration's own test on the true residual,
  min(r / atol, r / (rtol max_f ||b_f||_2)); the configuration states that
  a converged step reads under 1.
- ``resid_gap``: |r - r_claimed| / r, how far the residual the solver
  claims lies from the residual its x has.  In float64 the two agree to
  rounding; a lower precision, or an x or b altered after the solver's
  test, parts them.

The reference judges at most ``CHECKED`` steps a run: the first (from
the zero state), the last, and a sample of the others drawn from the
seed; each judged step needs only the two solutions before it, which
every step hands on.  A run's reading of each number is its worst judged
step.  A step fails when it did not claim convergence or a reading
passes its limit.
"""

from __future__ import annotations

import numpy as np

CHECKED = 24


def step_readings(system, t: float, x: np.ndarray, x1: np.ndarray, x2: np.ndarray,
                  claimed: float, rtol: float, atol: float) -> dict:
    """The two readings of one step (module docstring)."""
    b = system.rhs(t, x1, x2)
    r = b - system.A @ x
    ea = max(float(np.max(np.abs(r[s]))) for s in system.slices)
    b0 = max(float(np.linalg.norm(b[s])) for s in system.slices)
    q = min(ea / atol, ea / (rtol * b0)) if b0 > 0 else ea / atol
    gap = abs(ea - claimed) / max(ea, np.finfo(float).tiny)
    return {"resid_q": q, "resid_gap": gap}


def sample(n: int, seed: int) -> list[int]:
    """The steps to judge of ``n``: all up to CHECKED, else the first, the
    last and CHECKED - 2 others drawn from the seed."""
    if n <= CHECKED:
        return list(range(n))
    rng = np.random.default_rng(int(seed))
    inner = rng.choice(np.arange(1, n - 1), CHECKED - 2, replace=False)
    return sorted([0, n - 1, *(int(i) for i in inner)])


def judge(system, steps, rtol: float, atol: float, limits: dict,
          picked: list[int]) -> tuple[dict, int]:
    """Readings over the ``picked`` of ``steps`` (objects with t, x,
    claimed, converged, in order from the first step after the zero
    state): (worst reading of each number, number of failed steps: the
    unconverged ones among all, and the picked ones past a limit)."""
    zero = np.zeros(system.n)
    worst = {name: 0.0 for name in limits}
    failed = sum(not st.converged for st in steps)
    for k in picked:
        st = steps[k]
        x1 = steps[k - 1].x if k >= 1 else zero
        x2 = steps[k - 2].x if k >= 2 else zero
        rd = step_readings(system, st.t, np.asarray(st.x, dtype=np.float64), x1, x2,
                           st.claimed, rtol, atol)
        rd = {name: v if np.isfinite(v) else float("inf") for name, v in rd.items()}
        for name in worst:
            worst[name] = max(worst[name], rd[name])
        failed += st.converged and any(rd[name] > limits[name] for name in limits)
    return worst, failed

# Copy of porotpu/models/abstract.py; it prints through ``log`` and has no solution export yet.
"""Time-stepping physics base class (reference lib/AbstractPhysics.py).

Owns the time loop ``solve()``: advance t by dt, call solve_time_step(t),
log per-step iteration counts and wall time (reference
lib/AbstractPhysics.py:59-82 prints
"-------- Solved time t=... . N iterations in T s").
"""

from __future__ import annotations

import time as _time


def log(*args):
    """Print and flush.  The port's counterpart of porotpu's ``parprint``,
    which imports jax to ask the process index (porotpu/utils/printing.py)."""
    print(*args, flush=True)


class AbstractPhysics:
    def __init__(self, parameters: dict, mesh, parser=None):
        self.parameters = dict(parameters)
        if parser is not None:
            self.parameters.update(parser.options_dict)
        self.mesh = mesh
        self.dim = mesh.dim

        required = ["t0", "tf", "dt", "output name"]
        assert all(
            x in self.parameters for x in required
        ), "Missing arguments in parameters: {}".format(required)

        self.t0 = self.parameters["t0"]
        self.t = self.t0
        self.tf = self.parameters["tf"]
        self.dt = self.parameters["dt"]
        self.output_solutions = self.parameters.get("output solutions", False)
        self.output_name = self.parameters["output name"]
        if self.output_solutions:
            raise NotImplementedError("solution export is not ported yet (ROADMAP M7)")

    def solve_time_step(self, t) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def solve(self):
        """Run the full time loop; returns per-step iteration counts."""
        t0_simulation = _time.perf_counter()
        current_time = _time.perf_counter()
        iterations = []
        while self.t < self.tf - 1e-12:
            self.t += self.dt
            its = self.solve_time_step(self.t)
            iterations.append(its)
            log(
                "-------- Solved time t={:.2f}. {} iterations in {:.2f}s".format(
                    self.t, its, _time.perf_counter() - current_time
                )
            )
            current_time = _time.perf_counter()
        log(
            "Total simulation time = {}s\n".format(
                _time.perf_counter() - t0_simulation
            )
        )
        return iterations

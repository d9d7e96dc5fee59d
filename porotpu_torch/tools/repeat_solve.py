"""Run one driver command line twice and compare the two solves bit for bit.

    python -m porotpu_torch.tools.repeat_solve DRIVER [driver arguments ...]
    python -m porotpu_torch.tools.repeat_solve footing -N 20 \\
        --petsc-options petsc-options-inexact --pc-type "undrained 3-way"

DRIVER is a module of ``porotpu_torch.drivers`` (swelling, footing,
swelling_3d).  Each run is the driver's own: ``setup`` on the command
line, then ``solve()``, in this process, one after the other.  Printed:
the iteration counts of each run, its dispatch counts and ELL products
(with the ELL kernel's launches and the plain ELL products),
whether the two solutions are equal bit for bit and their largest
difference.  It exits 1 when the counts or the solutions differ: on the
card a sum whose order changes from run to run (an atomic add) shows
here.  It runs on the card, unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import importlib
import subprocess
import sys


def run(driver: str, argv: list[str]):
    """(iterations, solution on the host, counts, ELL products) of one run."""
    import torch

    from porotpu_torch.ops import dia_kernel
    from porotpu_torch.ops.sparse import ELL_PRODUCTS

    drv = importlib.import_module(f"porotpu_torch.drivers.{driver}")
    problem = drv.setup(argv)
    dia_kernel.reset_counts()
    ELL_PRODUCTS.clear()
    its = problem.solve()
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    ell = {"matvec": 0, "rmatvec": 0}
    for (product, *_), n in ELL_PRODUCTS.items():
        ell[product] += n
    ell.update(dia_kernel.ELL_COUNTS)  # the kernel's launches and the plain products
    return its, problem.sol.cpu(), dict(dia_kernel.COUNTS), ell


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    driver, rest = argv[0], argv[1:]
    if "--device" not in rest:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
        print(smi, flush=True)
    runs = [run(driver, rest) for _ in range(2)]
    for k, (its, _, counts, ell) in enumerate(runs):
        print(f"repeat_solve run {k + 1}: iterations {its}, counts {counts}, ELL products {ell}",
              flush=True)
    (its1, x1, _, _), (its2, x2, _, _) = runs
    diff = (x1 - x2).abs().max().item()
    same = its1 == its2 and bool((x1 == x2).all())
    print(f"repeat_solve {driver} {' '.join(rest)}: counts {its1} and {its2}, "
          f"x bit for bit {'equal' if same else 'DIFFERENT'}, max |x1 - x2| = {diff:.3e}",
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

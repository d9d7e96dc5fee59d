"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or porotpu (the JAX package) in a run, names compared whole;
nothing of the port in the reference; no result without a card."""

import json
import os
import shutil
import subprocess
import sys

from solverbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _loaded_after(code):
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "porotpu_torch_fixture", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary_fixture", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "porotpu.fixture", sys)
    assert "porotpu" in harness.forbidden_modules()


def test_harness_and_a_cpu_run_load_no_jax_package():
    code = (
        "import io, time\n"
        "from solverbench import harness, check, trace, traffic, roofline, spec\n"
        "from porotpu_torch.drivers import footing, swelling\n"
        "from porotpu_torch.ops import dia_kernel, sparse\n"
    )
    loaded = _loaded_after(code)
    assert not loaded & {"jax", "jaxlib", "flax", "porotpu"}


def test_reference_loads_nothing_of_the_port():
    code = (
        "from solverbench.reference import system, footing2d, swelling2d, loads\n"
        "from solverbench import check\n"
        "s = system.System(swelling2d, 3, swelling2d.loads({'ff_sur': 1.0, 'fs_sur': 1.0}))\n"
    )
    loaded = _loaded_after(code)
    assert not loaded & {"jax", "jaxlib", "flax", "porotpu", "porotpu_torch", "torch"}


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # the look for a card is what this checks
    shutil.copytree(os.path.join(ROOT, "solverbench"), tmp_path / "solverbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for root in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "solverbench/run.py", "--workload", "footing-n20-inexact",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout.strip() == ""

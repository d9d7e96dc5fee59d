"""Fixtures of the harness's own tests (run by hand: ``python -m pytest
solverbench/tests -q``; ``pytest tests/`` does not collect them).

``fixture_root`` lays out a checkout-like folder with its own
``BENCHMARK.json`` and data files, the two cells' configurations cut to a
CPU size and their traffic to ``TINY_STEPS`` steps, so that the harness
finds every piece by name there.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_N = {"footing2d-n20": 4, "swelling2d-n160": 6}
TINY_STEPS = 4


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def fixture_root(tmp_path):
    """A root whose BENCHMARK.json is the repository's, with every
    configuration at TINY_N."""
    data = tmp_path / "solverbench"
    src = os.path.join(ROOT, "solverbench")
    shutil.copytree(os.path.join(src, "metrics"), data / "metrics")
    shutil.copytree(os.path.join(src, "traffic"), data / "traffic")
    for path in (data / "traffic").glob("*.json"):
        trf = json.loads(path.read_text())
        trf["steps"] = TINY_STEPS
        path.write_text(json.dumps(trf))
    (data / "configs").mkdir()
    for name in os.listdir(os.path.join(src, "configs")):
        with open(os.path.join(src, "configs", name)) as f:
            cfg = json.load(f)
        cfg["N"] = TINY_N[cfg["name"]]
        (data / "configs" / name).write_text(json.dumps(cfg))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return tmp_path


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)

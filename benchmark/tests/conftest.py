"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): a copy of the benchmark whose configurations are cut
to a few hundred rows, for runs on the CPU, and the ``card`` marker's
check for a CUDA device, made inside a fixture."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"poisson3d_g48": 8, "poisson3d_g200": 8}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def copy_root(dest: str, grids: dict = TINY) -> str:
    """BENCHMARK.json and benchmark/ (without its tests) under ``dest``,
    each configuration's grid set from ``grids``."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, g in grids.items():
        path = os.path.join(dest, "benchmark", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["matrix"]["grid"] = g
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return copy_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")

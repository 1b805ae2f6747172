"""Shared pieces of the benchmark's tests: the ``cuda`` marker, and small
copies of the benchmark (its files, the configurations cut to a size the
CPU fits in a second) in a temporary root."""

import json
import pathlib
import shutil

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# Per configuration: the sizes the CPU tests run it at.
SMALL = {
    "corral_tall_10m": dict(rows=16384, cols=96, targets=3),
    "corral_fig7_1m_50k": dict(rows=8192, cols=512, targets=3),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")
    return torch.device("cuda")


def small_root(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark under ``tmp`` with every configuration cut to
    its ``SMALL`` size."""
    shutil.copytree(BENCH, tmp / BENCH.name, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, sizes in SMALL.items():
        path = tmp / BENCH.name / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(sizes)
        path.write_text(json.dumps(config))
    return tmp


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path)

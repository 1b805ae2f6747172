"""The PyTorch port's examples (``examples/*_torch.py``), each run as a
script in a subprocess with ``--device cpu``: exit 0 and the example's own
printed checks, with ``jax`` and the JAX package ``repro`` unimportable in
the process (so neither can be imported by the example or by anything of
``repro_torch`` it reaches).  Without ``--device`` each runs on the card,
and here, where torch sees none, raises before it computes anything.  The
two LM examples are run by ``test_torch_examples_lm.py`` (a file of their
own, so the test workers share the examples' minutes)."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["quickstart", "custom_score", "feature_selection_pipeline", "serve_lm", "train_lm"]

# Runs the example as ``__main__`` with jax and repro blocked: an import of
# either raises ModuleNotFoundError.
_RUNNER = """
import runpy, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
"""


def _run(name: str, *args: str, timeout: float = 240.0) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    return subprocess.run([sys.executable, "-c", _RUNNER, path, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)


def _ok(proc) -> str:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_an_example_imports_neither_jax_nor_repro(name):
    src = open(os.path.join(ROOT, "examples", f"{name}_torch.py")).read()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"argparse", "json", "subprocess", "sys", "tempfile", "time", "numpy",
                     "torch", "repro_torch"}, roots


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_device_an_example_raises_where_there_is_no_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    proc = _run(name, timeout=120)
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr


def test_quickstart():
    out = _ok(_run("quickstart", "--device", "cpu"))
    assert "device: cpu" in out
    assert out.count("relevant recovered: [0, 1, 2, 3, 4, 5, 6, 7, 8] (9/9)") == 2
    assert "(criterion='miq', engine='conventional')" in out
    assert len(re.findall(r"relevant recovered: 9/9\)", out)) == 2  # jmi, cmim
    mem, streamed = re.search(r"binned: in-memory (\[.*?\]) == streaming (\[.*?\])", out).groups()
    assert mem == streamed
    passes = re.search(r"plain passes=(\d+) vs batched\+spill\+readahead=(\d+)", out).groups()
    assert int(passes[1]) < int(passes[0])
    assert "resubmission cache_hit=True" in out
    assert "per-host share of bytes read: [0.5, 0.5]" in out


def test_custom_score():
    out = _ok(_run("custom_score", "--device", "cpu"))
    recovered = [int(n) for n in re.findall(r"signal cols \(0-7\) recovered: (\d)/8", out)]
    assert len(recovered) == 3 and min(recovered) >= 7, out
    assert out.count("(encoding=alternative)") == 3


def test_feature_selection_pipeline():
    out = _ok(_run("feature_selection_pipeline", "--device", "cpu"))
    acc = {k: float(v) for k, v in re.findall(r"test acc — (?:all )?\d+ (\w+) features?:\s+"
                                               r"([\d.]+)", out)}
    assert acc["mRMR"] > acc["random"] + 0.05 and acc["mRMR"] > 0.9, acc

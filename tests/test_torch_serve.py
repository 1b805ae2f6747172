"""repro_torch serving vs the JAX package's ``ServeEngine``.

Both engines serve the same requests with the same weights (the JAX
parameters loaded into the port with ``params_from_jax``), float32 on the
CPU: greedy tokens must be identical, request by request, over three prompt
lengths (three waves) and with an end-of-sequence token.  The temperature
path must be reproducible from its seed.  The serve command line runs on
the CPU and prints one JSON line naming the device.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["yi-6b", "qwen1.5-0.5b"])
def engines(request):
    arch = request.param
    bundle = jax_build_model(jax_smoke_config(arch), mesh=None)
    params = bundle.init(jax.random.PRNGKey(2))
    model = build_model(smoke_config(arch), device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, params))
    return bundle, params, model


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


LENGTHS = [9, 4, 17, 9, 4, 4]  # three waves: 4 x3, 9 x2, 17 x1


def test_greedy_tokens_equal_jax(engines):
    bundle, params, model = engines
    prompts = _prompts(model.cfg.vocab_size, LENGTHS)
    news = [6, 5, 6, 3, 6, 4]
    want = JaxServeEngine(bundle, params).serve(
        [JaxRequest(p, n) for p, n in zip(prompts, news)])
    engine = ServeEngine(model)
    got = engine.serve([Request(p, n) for p, n in zip(prompts, news)])
    assert got == want
    assert [len(t) for t in got] == news
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(3, 4), (2, 9), (1, 17)]


def test_greedy_with_eos_equal_jax(engines):
    bundle, params, model = engines
    prompts = _prompts(model.cfg.vocab_size, LENGTHS, seed=1)
    first = ServeEngine(model).serve([Request(p, 6) for p in prompts])
    eos = first[0][2]  # a token that request 0 emits: its output stops there
    want = JaxServeEngine(bundle, params).serve([JaxRequest(p, 6, eos) for p in prompts])
    got = ServeEngine(model).serve([Request(p, 6, eos) for p in prompts])
    assert got == want
    assert got[0] == first[0][:2]


def test_temperature_is_reproducible_from_its_seed(engines):
    _, _, model = engines
    reqs = [Request(p, 8) for p in _prompts(model.cfg.vocab_size, [5, 5, 7], seed=2)]
    a = ServeEngine(model, temperature=0.8, seed=3).serve(reqs)
    b = ServeEngine(model, temperature=0.8, seed=3).serve(reqs)
    c = ServeEngine(model, temperature=0.8, seed=4).serve(reqs)
    greedy = ServeEngine(model).serve(reqs)
    assert a == b
    assert a != c and a != greedy
    assert all(0 <= t < model.cfg.vocab_size for row in a for t in row)


def test_cli_prints_one_json_line_naming_the_device():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
           "--preset", "smoke", "--device", "cpu", "--requests", "3",
           "--prompt-len", "12", "--max-new-tokens", "5"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=120)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["arch"] == "yi-6b"
    assert rec["new_tokens"] == 15 and rec["requests"] == 3


@pytest.mark.parametrize("argv", [
    ["--ckpt-dir", "ckpt", "--device", "cpu"],
    ["--model-parallel", "2", "--arch", "mamba2-1.3b", "--device", "cpu"],
])
def test_cli_refuses_what_is_not_ported(argv):
    # Checkpoints are ported (a directory without one is refused; loading
    # one is held in test_torch_train_cli.py); model parallelism is ported
    # for every family (test_torch_model_parallel.py and
    # test_torch_model_parallel_families.py), and refused where the mesh
    # positions (REPRO_DEVICES, one here) do not split into it.
    match = "no checkpoint" if "--ckpt-dir" in argv else "do not split"
    with pytest.raises(SystemExit, match=match):
        serve_cli.main(argv)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--requests", "1"])

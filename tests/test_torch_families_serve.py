"""Serving the other LM families: repro_torch vs the JAX package.

Greedy ``ServeEngine`` tokens equal the JAX engine's for the five
decoder-only families (dbrx, llama4-scout, mamba2, jamba, qwen2-vl smoke
configs, float32, the JAX weights loaded with ``params_from_jax``) over
chunk-aligned and short-prompt waves (jamba also as ``jamba-cut``, its
smoke config cut as the card serves the published one: ``JAMBA_CUT``);
whisper is refused by both engines
and served by ``EncDecLM.greedy``; the serve command line runs each new
arch on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from torch_train_cases import JAMBA_CUT_CASE, smoke_configs

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

FAMILIES = ["dbrx-132b", "llama4-scout-17b-a16e", "mamba2-1.3b", "jamba-1.5-large-398b",
            "qwen2-vl-2b", "whisper-tiny"]
DECODERS = FAMILIES[:-1]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _frames(cfg, b, s, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            ).astype(np.float32)


@pytest.fixture(scope="module", params=DECODERS + [JAMBA_CUT_CASE])
def engines(request):
    jax_cfg, cfg = smoke_configs(request.param)
    bundle = jax_build_model(jax_cfg, mesh=None)
    params = bundle.init(jax.random.PRNGKey(2))
    model = build_model(cfg, device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, params))
    return bundle, params, model


def test_greedy_tokens_equal_jax(engines):
    """Waves of 64 tokens (two SSD chunks of 32) and of 9 (a short prompt:
    one chunk of the prompt's length), each with requests of differing
    new-token counts."""
    bundle, params, model = engines
    rng = np.random.default_rng(0)
    lengths, news = [9, 64, 9, 64], [5, 4, 3, 5]
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist() for n in lengths]
    want = JaxServeEngine(bundle, params).serve(
        [JaxRequest(p, n) for p, n in zip(prompts, news)])
    engine = ServeEngine(model)
    got = engine.serve([Request(p, n) for p, n in zip(prompts, news)])
    assert got == want
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(2, 9), (2, 64)]


def test_encdec_refused_by_the_engine_as_in_jax():
    with pytest.raises(NotImplementedError, match="decoder-only"):
        JaxServeEngine(jax_build_model(jax_smoke_config("whisper-tiny"), mesh=None), {})
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(build_model(smoke_config("whisper-tiny"), device="cpu"))


def test_encdec_greedy_is_prefill_then_steps():
    model = build_model(smoke_config("whisper-tiny"), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    frames = torch.from_numpy(_frames(model.cfg, 2, 30, seed=1))
    prompt = torch.from_numpy(_tokens(model.cfg, 2, 4, seed=1))
    toks, stats = model.greedy(frames, prompt, 5)
    assert toks.shape == (2, 5) and stats["decode_steps"] == 4
    seq = prompt
    for i in range(5):  # the same tokens from a fresh prefill of the grown prompt
        logits, _ = model.prefill(frames, seq)
        nxt = torch.argmax(logits, dim=-1)
        assert torch.equal(nxt, toks[:, i]), i
        seq = torch.cat([seq, nxt[:, None]], dim=1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_serves_every_decoder_family(arch, capsys):
    rec = serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                          "--prompt-len", "8", "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert rec["device"] == "cpu" and rec["arch"] == arch and rec["new_tokens"] == 6
    assert rec["family"] == smoke_config(arch).family


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_cli_refuses_an_ssm_prompt_shorter_than_its_conv_cache(arch):
    """The prefill keeps the prompt's last ssm_conv - 1 (3) conv inputs; a
    shorter prompt cannot decode, in either package, so it is refused
    before the prefill runs.  One new token needs no decode step."""
    argv = ["--arch", arch, "--device", "cpu", "--requests", "1", "--prompt-len", "2"]
    with pytest.raises(ValueError, match="conv window"):
        serve_cli.main([*argv, "--max-new-tokens", "2"])
    assert serve_cli.main([*argv, "--max-new-tokens", "1"])["new_tokens"] == 1
    assert serve_cli.main([*argv[:-1], "3", "--max-new-tokens", "2"])["new_tokens"] == 2

"""The sequence-parallel residual on a model mesh, served: the SSM, hybrid
and encoder-decoder families against the JAX package.

mamba2, jamba's eight-layer superblock (Mamba, attention and MoE layers)
and whisper smoke configs with ``seq_shard_activations=True`` on (1, 2),
(1, 4) and (2, 2) meshes of ``"cpu"`` positions (``torch_sp_cases``).  A
Mamba mixer gathers the normed slices before its input projections (the
causal conv and the SSD read the whole sequence) and reduce-scatters its
``out`` partials; whisper's encoder residual is sliced by its 24 frames,
its decoder's by the prompt, and the cross-attention reads the encoder
output gathered over ``model``.  Prefill logits, every gathered cache leaf
(k, v, xk, xv, the SSM state and conv tails), a decode step and greedy
tokens (whisper's the port's one-device ``greedy``) against JAX's
single-device bundle and the one-device model at ``1e-5``, jamba at
``1e-4``; jamba also as ``jamba-cut`` (``JAMBA_CUT``: an attention layer,
then a Mamba-2 layer with the MoE), the pattern the card serves on (1, 4)
at the published widths.
"""

import pytest
import torch
from torch_sp_cases import MESHES, NEWS, hold_serve, mesh, serve_want, sp_pair
from torch_train_cases import JAMBA_CUT_CASE
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.models.model import shard_params
from repro_torch.serve import Request, ServeEngine

ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"]


@pytest.fixture(scope="module", params=ARCHS + [JAMBA_CUT_CASE])
def pair(request):
    bundle, params, model = sp_pair(request.param)
    return serve_want(bundle, params, model), model


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_prefill_caches_and_step_match_jax(pair, shape):
    want, model = pair
    hold_serve(model, shard_params(model, mesh(shape)), want)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_greedy_tokens_equal_the_reference(pair, shape):
    want, model = pair
    meshed = shard_params(model, mesh(shape))
    if model.cfg.is_encdec:
        frames, prompt, tokens = want["greedy"]
        got, stats = meshed.greedy(frames, prompt, 5)
        assert torch.equal(got, tokens) and stats["decode_steps"] == 4
        return
    prompts, tokens = want["greedy"]
    engine = ServeEngine(meshed)
    assert engine.serve([Request(p, n) for p, n in zip(prompts, NEWS)]) == tokens
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(2, 10), (2, 32)]

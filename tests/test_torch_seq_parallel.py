"""The sequence-parallel residual (Megatron-SP, JAX's
``seq_shard_activations``) on a model mesh, served: the dense, VLM and MoE
decoder-only families against the JAX package.

yi-6b (dense), qwen2-vl (embeddings in, M-RoPE; at tp = 4 its two KV heads
do not divide), dbrx and llama4-scout (expert parallel, sigmoid router and
shared expert) smoke configs with ``seq_shard_activations=True`` on (1, 2),
(1, 4) and (2, 2) meshes of ``"cpu"`` positions (``torch_sp_cases``):
each position holds its slice of the prompt's residual between blocks, the
normed slices gathered before the column-parallel products, the
row-parallel partials reduce-scattered.  The prefill logits, the gathered
caches, a decode step (S = 1: the residual whole) and greedy
``ServeEngine`` tokens (waves of 32 and 10 tokens: 10 does not divide by
4) against JAX's single-device bundle and the port's one-device model at
``1e-5``.  The SSM, hybrid and encoder-decoder families are in
``test_torch_seq_parallel_families.py``.
"""

import pytest
from torch_sp_cases import MESHES, NEWS, hold_serve, mesh, serve_want, sp_pair
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.models.model import shard_params
from repro_torch.serve import Request, ServeEngine

ARCHS = ["yi-6b", "qwen2-vl-2b", "dbrx-132b", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    bundle, params, model = sp_pair(request.param)
    assert model.cfg.seq_shard_activations
    return serve_want(bundle, params, model), model


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_prefill_caches_and_step_match_jax(pair, shape):
    want, model = pair
    meshed = shard_params(model, mesh(shape))
    assert meshed.ctx.act_seq == "model" and meshed.ctx.at_length(32).seq == "model"
    hold_serve(model, meshed, want)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_greedy_tokens_equal_the_jax_engine(pair, shape):
    want, model = pair
    prompts, tokens = want["greedy"]
    engine = ServeEngine(shard_params(model, mesh(shape)))
    assert engine.serve([Request(p, n) for p, n in zip(prompts, NEWS)]) == tokens
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(2, 10), (2, 32)]

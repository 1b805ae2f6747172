"""The token data of training vs the JAX package's: ``SyntheticTokenSource``
blocks and ``ShardedDataPipeline.batch_at`` bitwise equal (the port on 1
and 2 positions, JAX on its one CPU device: the global batch is the same on
any mesh), and ``lm_token_batches`` (``jax.random`` there, a
``torch.Generator`` here) held by shapes and marginal."""

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import ShardedDataPipeline as JaxPipeline
from repro.data.sources import SyntheticTokenSource as JaxTokenSource
from repro.data.synthetic import lm_token_batches as jax_lm_token_batches
from repro.dist.meshes import make_mesh as jax_make_mesh

from repro_torch.data import ShardedDataPipeline, SyntheticTokenSource, lm_token_batches
from repro_torch.dist import make_mesh


@pytest.mark.parametrize("seed", [0, 7])
def test_token_source_blocks_are_bitwise_jax(seed):
    ours, theirs = SyntheticTokenSource(6, 33, 1000, seed), JaxTokenSource(6, 33, 1000, seed)
    for step in (0, 1, 5, 123):
        for lo, hi in ((0, 6), (2, 5), (5, 6)):
            a, b = ours.block(step, lo, hi), theirs.block(step, lo, hi)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("positions", [1, 2])
def test_batch_at_is_bitwise_jax(positions):
    mesh = make_mesh((positions,), ("data",), devices=["cpu"] * positions)
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=4, seq_len=16, vocab=512, seed=3)
    jpipe = JaxPipeline(mesh=jax_make_mesh((1,), ("data",)), global_batch=4, seq_len=16,
                        vocab=512, seed=3)
    for step in (0, 2, 9):
        got, want = pipe.batch_at(step), jpipe.batch_at(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32 and got[k].shape == (4, 16)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(), got["targets"][:, :-1].numpy())


def test_each_position_reads_only_its_rows():
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    calls = []

    class Spy(SyntheticTokenSource):
        def block(self, step, lo, hi):
            calls.append((step, lo, hi))
            return super().block(step, lo, hi)

    pipe = ShardedDataPipeline(mesh=mesh, global_batch=6, seq_len=8, vocab=50,
                               source=Spy(6, 8, 50, 1))
    shards = pipe.shards_at(4)
    assert calls == [(4, 0, 3), (4, 3, 6)]
    full = SyntheticTokenSource(6, 8, 50, 1).block(4, 0, 6)
    for i, shard in enumerate(shards):
        np.testing.assert_array_equal(shard["tokens"].numpy(), full[3 * i:3 * i + 3, :8])
    with pytest.raises(ValueError, match="divisible"):
        ShardedDataPipeline(mesh=mesh, global_batch=5, seq_len=8, vocab=50)


def test_lm_token_batches_shapes_and_marginal():
    b, s, vocab, n = 16, 256, 1000, 4
    ours = list(lm_token_batches(0, b, s, vocab, n))
    theirs = list(jax_lm_token_batches(jax.random.PRNGKey(0), b, s, vocab, n))
    assert len(ours) == len(theirs) == n
    for o, t in zip(ours, theirs):
        for name in ("tokens", "targets", "mask"):
            got, want = getattr(o, name), getattr(t, name)
            assert tuple(got.shape) == tuple(want.shape) == (b, s)
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(o.tokens[:, 1:].numpy(), o.targets[:, :-1].numpy())
        assert bool((o.mask == 1).all())
    tok = np.concatenate([o.tokens.numpy().ravel() for o in ours])
    jtok = np.concatenate([np.asarray(t.tokens).ravel() for t in theirs])
    assert tok.min() >= 0 and tok.max() < vocab
    # u^2 * vocab: P(token < q * vocab) = sqrt(q); 16,384 draws each
    for q in (0.01, 0.25, 0.5, 0.9):
        p_ours, p_jax = (tok < q * vocab).mean(), (jtok < q * vocab).mean()
        assert abs(p_ours - np.sqrt(q)) < 0.02 and abs(p_jax - np.sqrt(q)) < 0.02, q
    assert not np.array_equal(tok, jtok)  # other random numbers, as documented
    np.testing.assert_array_equal(
        tok, np.concatenate([o.tokens.numpy().ravel() for o in lm_token_batches(0, b, s, vocab, n)]))

"""repro_torch flash attention (plain version and dispatch) vs the JAX package.

On the CPU ``ops.flash_attention`` runs the plain version
(``repro_torch.kernels.ref.flash_attention``); these tests hold it against the
JAX Pallas kernel in interpret mode where ``S == T`` (the only case whose
mask the Pallas kernel shares with the model), and against the JAX plain
version and the model's own ``full_attention`` where ``S < T``, ``S > T`` or
the length is ragged.  Float32 within ``rtol=2e-5, atol=2e-5``
(``tests/test_kernels.py``'s tolerance).  The CUDA kernel is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import full_attention

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import _readable, flash_attention_cuda, tma_readable

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, s, t, h, kv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(dtype)
    k = rng.standard_normal((b, t, kv, d)).astype(dtype)
    v = rng.standard_normal((b, t, kv, d)).astype(dtype)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "b,s,h,kv,d,causal,bq,bkv",
    [
        (2, 256, 8, 4, 64, True, 128, 128),
        (1, 128, 4, 4, 32, False, 128, 128),  # MHA
        (2, 512, 8, 2, 64, True, 128, 128),   # GQA group 4
        (1, 256, 8, 1, 128, True, 128, 128),  # MQA
        (1, 512, 8, 4, 64, True, 128, 128),   # the model's blockwise shape
        (1, 256, 4, 2, 64, True, 64, 128),    # block sweep
        (1, 256, 4, 2, 64, True, 128, 64),
        (1, 256, 4, 2, 64, True, 256, 256),
    ],
)
def test_plain_matches_pallas_interpret(b, s, h, kv, d, causal, bq, bkv):
    q, k, v = _qkv(b, s, s, h, kv, d, seed=s + h + kv)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=bq, block_kv=bkv,
                                  interpret=True)
    got = ops.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "s,t,h,kv,d,causal",
    [
        (64, 256, 8, 2, 64, True),   # s < t: query i sees keys <= i + t - s
        (1, 300, 8, 4, 128, True),   # one query against a long context
        (100, 100, 4, 2, 32, True),  # ragged length
        (37, 91, 4, 4, 64, False),   # ragged, non-causal
        (96, 40, 4, 2, 32, True),    # s > t: the first rows see no key
    ],
)
def test_plain_matches_jax_plain_off_diagonal(s, t, h, kv, d, causal):
    q, k, v = _qkv(2, s, t, h, kv, d, seed=s * t)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal)
    got = ops.flash_attention(*_torch(q, k, v), causal=causal)
    assert got.shape == (2, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    model = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(model), **TOL)


def test_bf16_output_dtype_and_tolerance():
    q, k, v = _qkv(2, 128, 128, 4, 4, 64, seed=4)
    qt, kt, vt = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    got = ref.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (qt, kt, vt)]
    want = flash_attention_pallas(*j, causal=True, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_dispatch_on_cpu_runs_the_plain_version():
    q, k, v = _torch(*_qkv(1, 64, 64, 4, 2, 32, seed=9))
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, use_kernel=False), got)
    assert flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, causal=True, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="use_kernel"):
        ops.flash_attention(q, k, v, causal=True, use_kernel="yes")


def _bf16(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).to(torch.bfloat16).view(shape)


def test_tma_rule_decides_copy_or_read_in_place():
    # The bf16 body loads q, k and v with TMA: a 16-byte-aligned start and
    # strides that are positive multiples of 16 bytes, else one copy.
    b, s, h, kv, d = 2, 12, 4, 2, 64
    x = _bf16(b, s, (h + 2 * kv) * d)
    q = x[..., : h * d].unflatten(-1, (h, d))  # the projection view: read in place
    k = x[..., h * d:(h + kv) * d].unflatten(-1, (kv, d))
    assert not q.is_contiguous() and tma_readable(q) and tma_readable(k)
    assert _readable(q) is q and _readable(k) is k
    odd_start = _bf16(b * s * h * d + 3)[3:].view(b, s, h, d)  # 6 bytes off
    odd_stride = _bf16(b, s, h, d + 4)[..., :d]  # rows 136 bytes apart
    broadcast = _bf16(1, s, kv, d).expand(b, s, kv, d)  # a zero batch stride
    for t in (odd_start, odd_stride, broadcast):
        assert not tma_readable(t)
        c = _readable(t)
        assert c is not t and tma_readable(c) and torch.equal(c, t)
    strided = torch.zeros(b, s, h, d + 4)[..., :d]  # float32 reads any stride in place
    assert _readable(strided) is strided
    every_other = strided[..., ::2]
    c = _readable(every_other)  # a strided last axis is copied
    assert c is not every_other and c.is_contiguous() and torch.equal(c, every_other)

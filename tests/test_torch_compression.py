"""Gradient compression (int8, a per-leaf scale, error feedback): the JAX
package's three cases (``tests/test_compression.py``) on the port, the
int8 payloads, scales and residuals bitwise JAX's on the same gradients,
and the compressed sum over an in-process mesh's positions and over two
gloo processes (``HostCollectives``; this file is each worker's script),
which agree bitwise."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from repro.train.compression import GradCompression as JaxGradCompression

from repro_torch.train import GradCompression, compressed_psum, compressed_psum_positions

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
LAUNCH_TIMEOUT = 300


def _grads(seed, n=256):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 32)).astype(np.float32),
            "b": (rng.standard_normal((128,)) * 10).astype(np.float32),
            "g": rng.standard_normal((n,)).astype(np.float32),
            "z": np.zeros((5,), np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_compress_roundtrip_error_bound():
    grads = _t(_grads(0))
    (q, s), state = GradCompression.init(grads).compress(grads)
    for k in grads:
        deq = q[k].to(torch.float32) * s[k]
        err = (deq - grads[k]).abs()
        assert float(err.max()) <= float(s[k]) * 0.5 + 1e-6  # half a step
        torch.testing.assert_close(state.residual[k], grads[k] - deq, rtol=0, atol=1e-6)
    assert float(s["z"]) == 1.0 and not q["z"].any()


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.tensor([0.3, -0.004, 0.0021, 1.7])}
    state = GradCompression.init(g)
    total = torch.zeros(4)
    for _ in range(50):
        (q, s), state = state.compress(g)
        total = total + q["w"].to(torch.float32) * s["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), rtol=0.02, atol=1e-4)


def test_payloads_scales_and_residuals_are_bitwise_jax():
    grads = _grads(1)
    jstate = JaxGradCompression.init({k: jnp.asarray(v) for k, v in grads.items()})
    state = GradCompression.init(_t(grads))
    for step in range(3):  # the residual carries across steps
        g = _grads(10 + step)
        (jq, js), jstate = jstate.compress({k: jnp.asarray(v) for k, v in g.items()})
        (q, s), state = state.compress(_t(g))
        for k in g:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(state.residual[k].numpy(),
                                          np.asarray(jstate.residual[k]))


def _position_grads(n):
    return [{"g": torch.from_numpy(_grads(100 + i)["g"]),
             "b": torch.from_numpy(_grads(100 + i)["b"])} for i in range(n)]


def test_compressed_psum_over_positions_matches_mean():
    n = 4
    grads = _position_grads(n)
    states = [GradCompression.init(g) for g in grads]
    out, new = compressed_psum_positions(grads, states, "cpu")
    assert len(new) == n
    for k in ("g", "b"):
        stack = torch.stack([g[k] for g in grads])
        # int8 with a shared scale: error ~1/127 of the largest magnitude
        tol = float(stack.abs().max()) / 127 * 1.01 + 1e-6
        assert float((out[k] - stack.mean(dim=0)).abs().max()) <= tol


def _worker() -> None:
    """One rank: the compressed sum over HostCollectives, bitwise the
    in-process positions' sum of the same gradients."""
    from repro_torch.dist import multihost as tmh

    ctx = tmh.init_multihost(timeout=60)
    rank, n = ctx.process_id, ctx.num_processes
    coll = tmh.HostCollectives(tmh.resolve_host_shards(40, 8, n, rank, grid=(n, 1)))
    grads = _position_grads(n)
    states = [GradCompression.init(g) for g in grads]
    want, want_states = compressed_psum_positions(grads, states, "cpu")
    got, state = compressed_psum(grads[rank], coll, states[rank], n)
    for k in got:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(state.residual[k], want_states[rank].residual[k]), k
    print(json.dumps(dict(rank=rank, ok=True)), flush=True)
    # Leave the group together, as launch.select_multihost does: a process
    # that exits with its gloo group alive can abort in the group's teardown
    # ("terminate called without an active exception").
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_compressed_psum_over_two_gloo_processes(tmp_path):
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=SRC,
                   REPRO_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
                   REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, __file__], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}\n{err[-3000:]}"
        assert json.loads(out.strip().splitlines()[-1]) == dict(rank=rank, ok=True)


if __name__ == "__main__":
    _worker()

"""The port's ``CheckpointManager``: the multi-process publish protocol
(the seven cases of ``tests/test_checkpoint_multiproc.py``, N writers
simulated on one directory through ``process_index``/``process_count``),
checkpoints read across the two packages in both directions, bfloat16
leaves included, ``elastic_restore`` onto another mesh, and a state on a
model mesh (an attention, a MoE and the encoder-decoder family): its files
are the gathered state's, byte for byte, and it restores onto the mesh,
onto another one and onto one device bitwise."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import train_state_shapes as jax_train_state_shapes

from repro_torch.dist import make_mesh
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime.checkpoint import flatten_with_paths
from repro_torch.runtime.resilience import elastic_restore
from repro_torch.train import (AdamWConfig, TrainState, gather_train_state, global_norm,
                               init_train_state, make_train_step, train_state_shapes)
from repro_torch.train.train_step import state_from_jax, state_to_jax

from torch_train_cases import batch_for, jax_pair


def _mgr(d, i, n, **kw):
    return CheckpointManager(str(d), use_async=False, process_index=i, process_count=n, **kw)


# -- the publish protocol (tests/test_checkpoint_multiproc.py) ---------------

def test_single_process_save_restore_roundtrip(tmp_path):
    mgr = _mgr(tmp_path, 0, 1)
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": np.int32(7)}
    mgr.save(3, state)
    assert mgr.latest_step() == 3
    restored = mgr.restore(3, state)
    np.testing.assert_array_equal(np.asarray(restored["w"]), state["w"])
    assert int(restored["step"]) == 7


def test_nonzero_process_never_publishes(tmp_path):
    mgr1 = _mgr(tmp_path, 1, 2)
    mgr1.save(0, {"b": np.ones(3, np.float32)})
    tmp = tmp_path / "step_00000000.tmp"
    assert (tmp / "proc_1.npz").exists()
    assert not (tmp / "manifest.json").exists()
    assert not (tmp_path / "step_00000000").exists()
    assert mgr1.all_steps() == []


def test_coordinator_publishes_once_all_shards_arrive(tmp_path):
    a = np.arange(4, dtype=np.float32)
    b = np.arange(5, dtype=np.float32) * 2
    _mgr(tmp_path, 1, 2).save(0, {"b": b})
    _mgr(tmp_path, 0, 2).save(0, {"a": a})
    final = tmp_path / "step_00000000"
    assert final.exists() and not (tmp_path / "step_00000000.tmp").exists()
    assert (final / "proc_0.npz").exists() and (final / "proc_1.npz").exists()
    restored = _mgr(tmp_path, 0, 2).restore(0, {"a": a * 0, "b": b * 0})
    np.testing.assert_array_equal(np.asarray(restored["a"]), a)
    np.testing.assert_array_equal(np.asarray(restored["b"]), b)


def test_coordinator_waits_for_straggler_thread(tmp_path):
    a, b = np.zeros(2, np.float32), np.ones(2, np.float32)
    t = threading.Timer(0.3, lambda: _mgr(tmp_path, 1, 2).save(0, {"b": b}))
    t.start()
    try:
        _mgr(tmp_path, 0, 2, publish_timeout=30.0).save(0, {"a": a})
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert (tmp_path / "step_00000000" / "manifest.json").exists()
    assert _mgr(tmp_path, 0, 2).latest_step() == 0


def test_coordinator_times_out_on_missing_shard(tmp_path):
    with pytest.raises(TimeoutError, match="proc_1.npz"):
        _mgr(tmp_path, 0, 2, publish_timeout=0.3).save(0, {"a": np.zeros(2, np.float32)})
    assert _mgr(tmp_path, 0, 2).all_steps() == []


def test_republish_same_step_replaces_cleanly(tmp_path):
    for val in (1.0, 2.0):
        arr = np.full(3, val, np.float32)
        _mgr(tmp_path, 1, 2).save(5, {"b": arr})
        _mgr(tmp_path, 0, 2).save(5, {"a": arr})
    restored = _mgr(tmp_path, 0, 2).restore(
        5, {"a": np.zeros(3, np.float32), "b": np.zeros(3, np.float32)})
    np.testing.assert_array_equal(np.asarray(restored["a"]), np.full(3, 2.0))
    np.testing.assert_array_equal(np.asarray(restored["b"]), np.full(3, 2.0))


def test_retention_gc_only_runs_on_coordinator(tmp_path):
    for step in range(5):
        _mgr(tmp_path, 1, 2).save(step, {"b": np.zeros(1, np.float32)})
        _mgr(tmp_path, 0, 2, keep=2).save(step, {"a": np.zeros(1, np.float32)})
    assert _mgr(tmp_path, 0, 2).all_steps() == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_async_save_lands_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((4,), float(step))})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert torch.equal(mgr.restore(3, {"w": torch.empty(4, device="meta")})["w"],
                       torch.full((4,), 3.0))


# -- across the two packages ------------------------------------------------

def _jax_trained_state(moment_dtype):
    """qwen's smoke config after one JAX step (moments non-zero)."""
    bundle, params, model = jax_pair("qwen1.5-0.5b")
    jcfg = JaxAdamWConfig(moment_dtype=moment_dtype)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, params), jcfg)
    batch = {k: jnp.asarray(v) for k, v in batch_for(bundle.cfg, 2, 16, seed=1).items()}
    state, _ = jax.jit(jax_make_train_step(bundle, jcfg))(state, batch)
    return bundle, jcfg, model, state


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bfloat16 as uint16), for bitwise comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.reshape(-1).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _assert_same_tree(got_port_state, model, jax_state):
    got = flatten_with_paths(state_to_jax(model, got_port_state))
    want = flatten_with_paths(jax.tree.map(np.asarray, {
        "params": jax_state.params, "opt": jax_state.opt, "step": jax_state.step}))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_a_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, moment_dtype):
    _, _, model, jstate = _jax_trained_state(moment_dtype)
    JaxCheckpointManager(str(tmp_path), use_async=False).save(1, jstate)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    like = state_to_jax(model, train_state_shapes(model, AdamWConfig(moment_dtype=moment_dtype)))
    state = state_from_jax(model, mgr.restore(1, like))
    assert state.opt["m"]["top.embed"].dtype == getattr(torch, moment_dtype)
    assert int(state.step) == 1 and int(state.opt["count"]) == 1
    _assert_same_tree(state, model, jstate)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_a_port_checkpoint_reads_in_jax(tmp_path, moment_dtype):
    bundle, jcfg, model, jstate = _jax_trained_state(moment_dtype)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    like = state_to_jax(model, train_state_shapes(model, AdamWConfig(moment_dtype=moment_dtype)))
    JaxCheckpointManager(str(tmp_path / "jax"), use_async=False).save(1, jstate)
    port_state = state_from_jax(model, CheckpointManager(str(tmp_path / "jax")).restore(1, like))
    CheckpointManager(str(tmp_path / "port"), use_async=False).save(
        1, state_to_jax(model, port_state))
    # The same files: keys, manifest and every leaf's bytes.
    files = {}
    for who in ("jax", "port"):
        with np.load(tmp_path / who / "step_00000001" / "proc_0.npz") as z:
            files[who] = {k: z[k] for k in z.files}
        assert (tmp_path / who / "step_00000001" / "manifest.json").read_text() == \
            (tmp_path / "jax" / "step_00000001" / "manifest.json").read_text()
    assert list(files["port"]) == list(files["jax"])  # JAX's flatten order
    for k, a in files["jax"].items():
        assert files["port"][k].dtype == a.dtype and files["port"][k].shape == a.shape, k
        np.testing.assert_array_equal(_bits(files["port"][k]), _bits(a), err_msg=k)
    jmgr = JaxCheckpointManager(str(tmp_path / "port"))
    jlike = jax_train_state_shapes(bundle, jcfg)
    if moment_dtype == "float32":
        restored = jmgr.restore(1, jlike)
        for (path, got), want in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                                     jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    else:
        # JAX's own restore cannot place a bfloat16 leaf read back as |V2
        # (ROADMAP.md §3.4); it fails alike on its own checkpoint.
        for who in ("port", "jax"):
            with pytest.raises(TypeError, match="V2"):
                JaxCheckpointManager(str(tmp_path / who)).restore(1, jlike)


def test_elastic_restore_onto_another_mesh(tmp_path):
    _, _, model = jax_pair("qwen1.5-0.5b")
    cfg = AdamWConfig()
    state = TrainState.create(model.flat_params(), cfg)
    state.step = state.step + 4
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    mgr.save(4, state_to_jax(model, state))
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    same, restored = elastic_restore(mgr, 4, model, cfg, mesh)
    assert same is model and int(restored.step) == 4
    for k, p in state.params.items():
        assert restored.params[k].device == mesh.devices.flat[0]
        assert torch.equal(restored.params[k], p), k
        assert torch.equal(restored.opt["v"][k], state.opt["v"][k])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-tiny"])
def test_a_restored_state_keeps_the_model_order(tmp_path, arch):
    """A state restored from a checkpoint (the JAX tree, sorted keys) comes
    back in ``named_parameters`` order, and the gradient norm a restart
    clips by does not depend on a dict's order at all: the same leaves in
    another order give bitwise the same norm, else a restart would part
    from an uninterrupted run by a rounding."""
    _, _, model = jax_pair(arch)
    state = TrainState.create(model.flat_params(), AdamWConfig())
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    mgr.save(0, state_to_jax(model, state))
    like = state_to_jax(model, train_state_shapes(model, AdamWConfig()))
    restored = state_from_jax(model, mgr.restore(0, like))
    order = [name for name, _ in model.named_parameters()]
    for tree in (restored.params, restored.opt["m"], restored.opt["v"]):
        assert list(tree) == order
    # One leaf's square is 2^24, every other leaf's 1: float32 sums of them
    # round differently in different orders.
    grads = {k: torch.zeros(p.shape) for k, p in state.params.items()}
    for i, g in enumerate(grads.values()):
        g.view(-1)[0] = 4096.0 if i == 0 else 1.0
    reordered = {k: grads[k] for k in reversed(order)}
    assert torch.equal(global_norm(reordered), global_norm(grads))


# -- a state on a model mesh ---------------------------------------------------

def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


def _meshed_state(arch, moment_dtype, mesh):
    """A smoke model's state on ``mesh`` after one step (moments non-zero)."""
    _, _, model = jax_pair(arch, fsdp=True, microbatches=1)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    state = init_train_state(model, cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_for(model.cfg, 4, 16, seed=1).items()}
    state, _ = make_train_step(model, cfg, mesh=mesh)(state, batch)
    return model, cfg, state


def _files(d):
    with np.load(d / "step_00000001" / "proc_0.npz") as z:
        return {k: z[k] for k in z.files}, (d / "step_00000001" / "manifest.json").read_text()


@pytest.mark.parametrize("arch,moment_dtype", [("qwen1.5-0.5b", "float32"),
                                               ("llama4-scout-17b-a16e", "bfloat16"),
                                               ("whisper-tiny", "float32")])
def test_a_meshed_checkpoint_is_the_gathered_states_bytes(tmp_path, arch, moment_dtype):
    """(2, 2) with fsdp: blocks over both axes, norms on all four positions;
    every leaf written whole, as one JAX process writes it."""
    mesh = _mesh((2, 2))
    model, _, state = _meshed_state(arch, moment_dtype, mesh)
    CheckpointManager(str(tmp_path / "mesh"), use_async=False).save(
        1, state_to_jax(model, state, mesh))
    CheckpointManager(str(tmp_path / "one"), use_async=False).save(
        1, state_to_jax(model, gather_train_state(model, state, mesh, "cpu")))
    (got, got_manifest), (want, want_manifest) = _files(tmp_path / "mesh"), _files(tmp_path / "one")
    assert got_manifest == want_manifest and list(got) == list(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(a), err_msg=k)


def test_restore_onto_the_mesh_gives_each_position_its_block(tmp_path):
    mesh = _mesh((2, 2))
    model, cfg, state = _meshed_state("qwen1.5-0.5b", "float32", mesh)
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    mgr.save(1, state_to_jax(model, state, mesh))
    like = state_to_jax(model, train_state_shapes(model, cfg, mesh=mesh), mesh)
    restored = state_from_jax(model, mgr.restore(1, like, shardings=mesh))
    assert int(restored.step) == 1 and int(restored.opt["count"]) == 1
    for got, want in ((restored.params, state.params), (restored.opt["m"], state.opt["m"]),
                      (restored.opt["v"], state.opt["v"])):
        assert len(got) == 4
        for i, (g, w) in enumerate(zip(got, want)):
            assert list(g) == list(w)
            for k in w:
                assert g[k].device == mesh.devices.flat[i]
                assert torch.equal(g[k], w[k]), (i, k)
    ptrs = {restored.params[i]["top.final_norm.w"].data_ptr() for i in range(4)}
    assert len(ptrs) == 4  # each position its own copy of a replicated leaf


def test_elastic_restore_from_22_onto_14_and_one_device(tmp_path):
    """(2, 2) -> (1, 4) -> one device, each state gathered bitwise the
    saved one, and a step on (1, 4) from the restored state runs."""
    mesh = _mesh((2, 2))
    model, cfg, state = _meshed_state("dbrx-132b", "float32", mesh)
    whole = gather_train_state(model, state, mesh, "cpu")
    mgr = CheckpointManager(str(tmp_path / "a"), use_async=False)
    mgr.save(1, state_to_jax(model, state, mesh))
    wide = _mesh((1, 4))
    same, on14 = elastic_restore(mgr, 1, model, cfg, wide)
    assert same is model and len(on14.params) == 4
    assert on14.params[0]["layers.0.attn.wq"].shape[1] == model.cfg.num_heads * \
        model.cfg.head_dim // 4
    mgr2 = CheckpointManager(str(tmp_path / "b"), use_async=False)
    mgr2.save(1, state_to_jax(model, on14, wide))
    _, one = elastic_restore(mgr2, 1, model, cfg, torch.device("cpu"))
    for got in (gather_train_state(model, on14, wide, "cpu"), one):
        assert int(got.step) == 1
        for k in whole.params:
            assert torch.equal(got.params[k], whole.params[k]), k
            assert torch.equal(got.opt["m"][k], whole.opt["m"][k])
            assert torch.equal(got.opt["v"][k], whole.opt["v"][k])
    batch = {k: torch.from_numpy(v) for k, v in batch_for(model.cfg, 4, 16, seed=2).items()}
    _, metrics = make_train_step(model, cfg, mesh=wide)(on14, batch)
    assert np.isfinite(float(metrics["loss"]))


def test_a_meshed_whisper_state_restores_from_22_onto_14_and_one_device(tmp_path):
    """The encoder-decoder state on (2, 2) (its ``enc_blocks`` and
    ``dec_blocks`` stacks written whole, the one-device bytes), through
    ``elastic_restore`` onto (1, 4) and onto one device, each gathered
    bitwise the saved state; a step on (1, 4) from it runs."""
    mesh = _mesh((2, 2))
    model, cfg, state = _meshed_state("whisper-tiny", "float32", mesh)
    whole = gather_train_state(model, state, mesh, "cpu")
    mgr = CheckpointManager(str(tmp_path / "a"), use_async=False)
    mgr.save(1, state_to_jax(model, state, mesh))
    CheckpointManager(str(tmp_path / "one"), use_async=False).save(1, state_to_jax(model, whole))
    (got, _), (want, _) = _files(tmp_path / "a"), _files(tmp_path / "one")
    assert any("enc_blocks" in k for k in want) and list(got) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(a), err_msg=k)
    wide = _mesh((1, 4))
    _, on14 = elastic_restore(mgr, 1, model, cfg, wide)
    assert on14.params[0]["dec_layers.0.cross.wq"].shape[1] == \
        model.cfg.num_heads * model.cfg.head_dim // 4
    mgr2 = CheckpointManager(str(tmp_path / "b"), use_async=False)
    mgr2.save(1, state_to_jax(model, on14, wide))
    _, one = elastic_restore(mgr2, 1, model, cfg, torch.device("cpu"))
    for got in (gather_train_state(model, on14, wide, "cpu"), one):
        assert int(got.step) == 1
        for k in whole.params:
            assert torch.equal(got.params[k], whole.params[k]), k
            assert torch.equal(got.opt["m"][k], whole.opt["m"][k])
            assert torch.equal(got.opt["v"][k], whole.opt["v"][k])
    batch = {k: torch.from_numpy(v) for k, v in batch_for(model.cfg, 4, 16, seed=2).items()}
    _, metrics = make_train_step(model, cfg, mesh=wide)(on14, batch)
    assert np.isfinite(float(metrics["loss"]))

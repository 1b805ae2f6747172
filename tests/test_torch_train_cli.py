"""``python -m repro_torch.launch.train`` on the CPU: a run with an injected
failure ends bitwise equal to an uninterrupted one (the JAX package claims
this of its train command line in a test file that does not exist, ROADMAP.md §3.4),
its per-step losses match the JAX package's single-device
``make_train_step`` from the same weights and batches, ``--model-parallel
2`` on four CPU positions (``REPRO_DEVICES=4``: a (2, 2) mesh) trains to
the losses of ``--model-parallel 1`` and restarts from an injected crash
bit for bit (the qwen and the mamba2 smoke configs), an encoder-decoder
arch is refused on one device and on the mesh alike, and ``launch.serve
--ckpt-dir`` serves the checkpoint's weights."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.sources import SyntheticTokenSource as JaxTokenSource
from repro.models.model import build_model as jax_build_model
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime.checkpoint import flatten_with_paths
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import AdamWConfig, train_state_shapes
from repro_torch.train.train_step import state_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--steps", "6", "--global-batch", "4", "--seq-len", "32",
        "--ckpt-every", "2", "--lr", "1e-3", "--warmup", "2"]


def _final(ckpt_dir, arch="qwen1.5-0.5b"):
    mgr = CheckpointManager(str(ckpt_dir))
    model = build_model(smoke_config(arch), device="cpu", dtype=torch.float32)
    like = state_to_jax(model, train_state_shapes(model, AdamWConfig()))
    return mgr.latest_step(), flatten_with_paths(mgr.restore(mgr.latest_step(), like))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    plain = train_cli.main(ARGS + ["--ckpt-dir", str(d / "plain")])
    failed = train_cli.main(ARGS + ["--ckpt-dir", str(d / "failed"), "--fail-at-step", "3"])
    return d, plain, failed


def test_restart_ends_bitwise_equal_to_an_uninterrupted_run(runs):
    d, plain, failed = runs
    assert plain["restarts"] == 0 and failed["restarts"] == 1
    assert plain["steps"] == failed["steps"] == 6
    assert failed["losses"] == plain["losses"] and len(plain["losses"]) == 6
    # the failed run re-ran step 2 after restoring step 2's checkpoint
    assert len(failed["step_s"]) == 7
    (step_a, a), (step_b, b) = _final(d / "plain"), _final(d / "failed")
    assert step_a == step_b == 6
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_losses_match_jax_make_train_step(runs):
    _, plain, _ = runs
    cfg = smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))  # the CLI's --seed 0
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          params_to_jax(model, model.flat_params()))
    bundle = jax_build_model(jax_smoke_config("qwen1.5-0.5b"), None)
    jcfg = JaxAdamWConfig(learning_rate=jax_warmup_cosine(1e-3, 2, 6))
    step_fn = jax.jit(jax_make_train_step(bundle, jcfg))
    state = JaxTrainState.create(params, jcfg)
    src = JaxTokenSource(4, 32, bundle.cfg.vocab_size, 0)
    want = []
    for step in range(6):
        blk = src.block(step, 0, 4)
        state, metrics = step_fn(state, {"tokens": jnp.asarray(blk[:, :32]),
                                         "targets": jnp.asarray(blk[:, 1:])})
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(plain["losses"], want, rtol=1e-5)


def test_without_ckpt_dir_each_run_checkpoints_apart(tmp_path, monkeypatch, runs):
    """No ``--ckpt-dir``: each run writes to a new directory under TMPDIR,
    so a second run trains from step 0 and never resumes the first's
    checkpoints."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ARGS + ["--steps", "2"]
    first, second = train_cli.main(args), train_cli.main(args)
    assert first["ckpt_dir"] != second["ckpt_dir"]
    for rec in (first, second):
        assert os.path.dirname(rec["ckpt_dir"]) == str(tmp_path)
        assert rec["steps"] == 2 and rec["last_ckpt"] == 2
        assert rec["losses"] == runs[1]["losses"][:2]


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mp")
    before = os.environ.get("REPRO_DEVICES")
    os.environ["REPRO_DEVICES"] = "4"
    try:
        mp = ARGS + ["--model-parallel", "2"]
        plain = train_cli.main(mp + ["--ckpt-dir", str(d / "plain")])
        failed = train_cli.main(mp + ["--ckpt-dir", str(d / "failed"), "--fail-at-step", "3"])
    finally:
        if before is None:
            del os.environ["REPRO_DEVICES"]
        else:
            os.environ["REPRO_DEVICES"] = before
    return d, plain, failed


def test_model_parallel_losses_match_one_device(runs, mp_runs):
    _, one, _ = runs
    _, plain, _ = mp_runs
    assert plain["mesh"] == {"data": 2, "model": 2} and one["mesh"] is None
    assert plain["steps"] == 6 and plain["last_ckpt"] == 6
    np.testing.assert_allclose(plain["losses"], one["losses"], rtol=1e-5)


def test_model_parallel_restart_is_bitwise_an_uninterrupted_run(runs, mp_runs):
    """The restart restores step 2's checkpoint onto the mesh and ends with
    the losses and the final checkpoint of the uninterrupted meshed run,
    bit for bit; that checkpoint is a whole-array one, as one device's."""
    d, plain, failed = mp_runs
    assert plain["restarts"] == 0 and failed["restarts"] == 1
    assert failed["losses"] == plain["losses"] and len(failed["step_s"]) == 7
    (step_a, a), (step_b, b) = _final(d / "plain"), _final(d / "failed")
    assert step_a == step_b == 6 and sorted(a) == sorted(b)
    _, one = _final(runs[0] / "plain")
    assert sorted(a) == sorted(one)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape == one[k].shape and a[k].dtype == one[k].dtype, k


def test_model_parallel_trains_an_ssm_arch_and_restarts_bitwise(tmp_path, monkeypatch):
    """mamba2's smoke config on the (2, 2) mesh: the losses of one device's
    run within ``1e-5``, and a run with an injected crash at step 3 bitwise
    the uninterrupted meshed run (losses and final checkpoint)."""
    argv = ARGS + ["--arch", "mamba2-1.3b"]
    one = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    monkeypatch.setenv("REPRO_DEVICES", "4")
    mp = argv + ["--model-parallel", "2"]
    plain = train_cli.main(mp + ["--ckpt-dir", str(tmp_path / "plain")])
    failed = train_cli.main(mp + ["--ckpt-dir", str(tmp_path / "failed"), "--fail-at-step", "3"])
    assert plain["mesh"] == {"data": 2, "model": 2} and plain["steps"] == 6
    np.testing.assert_allclose(plain["losses"], one["losses"], rtol=1e-5)
    assert (plain["restarts"], failed["restarts"]) == (0, 1)
    assert failed["losses"] == plain["losses"]
    (step_a, a), (step_b, b) = (_final(tmp_path / n, "mamba2-1.3b") for n in ("plain", "failed"))
    assert step_a == step_b == 6 and sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_an_encdec_arch_is_refused_on_one_device_and_on_the_mesh(tmp_path, monkeypatch):
    """The command line feeds token batches; whisper's loss reads frame
    embeddings: the same refusal with and without a model mesh."""
    argv = ARGS + ["--arch", "whisper-tiny", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="feeds token batches") as one:
        train_cli.main(argv)
    monkeypatch.setenv("REPRO_DEVICES", "4")
    with pytest.raises(SystemExit, match="feeds token batches") as meshed:
        train_cli.main(argv + ["--model-parallel", "2"])
    assert str(one.value) == str(meshed.value)


def test_serve_loads_the_checkpoint_and_decodes(runs):
    d, _, _ = runs
    argv = ["--device", "cpu", "--requests", "2", "--prompt-len", "8", "--max-new-tokens", "4",
            "--ckpt-dir", str(d / "plain")]
    rec = serve_cli.main(argv)
    assert rec["ckpt_step"] == 6 and rec["new_tokens"] == 8
    # the same greedy tokens from a model loaded by hand from that checkpoint
    model = build_model(smoke_config("qwen1.5-0.5b"), device="cpu")
    _, flat = _final(d / "plain")
    tree = {}
    for key, leaf in flat.items():
        path = key.split("\x1e")
        if path[0] != "params":
            continue
        node = tree
        for p in path[1:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    params_from_jax(model, tree)
    prompts = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 8))
    outs = ServeEngine(model).serve([Request(p.tolist(), 4) for p in prompts])
    assert [o[:8] for o in outs] == rec["first_tokens"]
    fresh = serve_cli.main(argv[:-2])  # random weights: other tokens
    assert fresh["ckpt_step"] is None and fresh["first_tokens"] != rec["first_tokens"]


def test_the_cli_prints_one_json_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "2",
           "--global-batch", "2", "--seq-len", "16", "--ckpt-dir", str(tmp_path),
           "--arch", "mamba2-1.3b", "--seq-len", "32"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True, timeout=120)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["arch"] == "mamba2-1.3b" and rec["steps"] == 2
    assert all(np.isfinite(rec["losses"]))

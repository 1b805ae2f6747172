"""Training command line on the card (port of ``repro.launch.train``).

Wires the training stack: a model of ``--arch`` with float32 master weights
computing in ``cfg.dtype``, AdamW with warmup-cosine, the deterministic
step-indexed token pipeline, async checkpoints in the JAX package's
layout, the step watchdog and the crash-restart loop.

    # qwen1.5-0.5b at its published widths on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --preset full --steps 10 --global-batch 8 --seq-len 2048 --ckpt-dir "$(mktemp -d)"

    # the reduced same-family config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --preset smoke --device cpu \\
        --steps 6 --global-batch 4 --seq-len 32 --ckpt-dir build/ckpt_smoke

Without ``--ckpt-dir`` the run checkpoints into a new directory of its own
(``tempfile.mkdtemp``, under ``TMPDIR``), named in the JSON line: a run
resumes (``--resume auto``) only from a directory it is given.
``--fail-at-step N`` injects one crash at the start of step N: the restart
loop restores the latest checkpoint and the run ends bit-identical to an
uninterrupted one (parameters and every step's loss).  On the card the
command first sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
``torch.use_deterministic_algorithms(True)``: the backward of the embedding
gather accumulates with atomics otherwise.

``--model-parallel N`` (N > 1) trains on the local mesh
``launch.mesh.build_local_mesh(N)``: ``(positions / N, N)`` on
``("data", "model")`` over ``REPRO_DEVICES`` positions of the device, the
state held as each position's blocks, the batch read a data shard a
position (``ShardedDataPipeline.shards_at``); checkpoints are the same
whole-array files, restored onto the mesh.  It takes every arch the
one-device command line takes::

    REPRO_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch mamba2-1.3b --model-parallel 2 --steps 6 --global-batch 4 --seq-len 32

The command line feeds token batches, as the JAX package's does: an
encoder-decoder arch (whisper), whose loss reads frame embeddings, is
refused on one device and on the mesh alike (train it through
``make_train_step`` with ``enc_embeds``, ``dec_tokens`` and ``targets``).

Prints one JSON line: the device, the mesh, the steps run, every step's
loss, the restarts and the seconds a step.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time

import torch

from repro_torch.data.pipeline import ShardedDataPipeline
from repro_torch.device import device_name, resolve_device
from repro_torch.dist.meshes import make_mesh
from repro_torch.launch.mesh import build_local_mesh
from repro_torch.launch.model_args import add_model_args, resolve_config
from repro_torch.models.model import build_model
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.resilience import StepWatchdog, run_with_restarts
from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
from repro_torch.train.train_step import (init_train_state, make_train_step, state_from_jax,
                                          state_to_jax, train_state_shapes)

log = logging.getLogger("repro_torch.train")

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(ap)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash once at this step (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def deterministic_card() -> None:
    """Bitwise-reproducible kernels on the card: a fixed cuBLAS workspace
    (read when cuBLAS first runs, so set before any product) and
    PyTorch's deterministic algorithms, which raise for an op that has
    none rather than run it nondeterministically."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = resolve_config(args)
    if cfg.is_encdec:
        raise SystemExit(f"--arch {cfg.name}: the command line feeds token batches; an "
                         "encoder-decoder model trains on enc_embeds, dec_tokens and targets "
                         "(make_train_step)")
    mesh = None
    if args.model_parallel != 1:
        mesh = build_local_mesh(args.model_parallel, device=dev)
    if dev.type == "cuda":
        deterministic_card()
    model = build_model(cfg, device=dev, dtype=torch.float32, compute_dtype=cfg.dtype,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(args.lr, args.warmup, args.steps),
                          moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(model, opt_cfg, mesh=mesh, donate=True)  # as JAX's jit donates
    pipe = ShardedDataPipeline(mesh=mesh or make_mesh((1,), ("data",), devices=[dev]),
                               global_batch=args.global_batch, seq_len=args.seq_len,
                               vocab=cfg.vocab_size, seed=args.seed)
    batch_at = pipe.batch_at if mesh is None else pipe.shards_at
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    if args.resume == "none" and ckpt.all_steps():
        raise SystemExit(f"--resume none: {args.ckpt_dir} already holds checkpoints "
                         f"{ckpt.all_steps()}, which a restart would restore; pass an "
                         "empty --ckpt-dir")
    failed_once = {"done": False}
    losses: dict = {}
    times: list = []
    restarts = {"n": -1}

    def make_state():
        return init_train_state(model, opt_cfg, mesh)

    def state_like():
        return state_to_jax(model, train_state_shapes(model, opt_cfg, mesh), mesh)

    def run_from(state):
        restarts["n"] += 1
        if isinstance(state.params, dict) and any(isinstance(v, dict)
                                                  for v in state.params.values()):
            state = state_from_jax(model, state, None if mesh else dev)  # restored: JAX layout
        start = int(state.step)
        try:
            with StepWatchdog(timeout_s=args.watchdog_s) as dog:
                for step in range(start, args.steps):
                    if step == args.fail_at_step and not failed_once["done"]:
                        failed_once["done"] = True
                        raise RuntimeError(f"injected failure at step {step}")
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch_at(step))
                    loss = float(metrics["loss"])  # waits for the step
                    times.append(time.perf_counter() - t0)
                    losses[step] = loss
                    dog.beat(step)
                    if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                        log.info("step %d loss %.4f %.3f s/step", step + 1, loss, times[-1])
                    if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                        ckpt.save(step + 1, state_to_jax(model, state, mesh))
        finally:
            ckpt.wait()  # a restart reads the checkpoint this attempt saved last
        return state

    t0 = time.perf_counter()
    state = run_with_restarts(make_state, run_from, ckpt=ckpt, state_like_fn=state_like,
                              shardings=mesh or dev, max_restarts=args.max_restarts)
    out = {"arch": cfg.name, "preset": args.preset, "device": device_name(dev),
           "mesh": None if mesh is None else mesh.shape,
           "params": model.num_params(), "compute_dtype": cfg.dtype,
           "steps": int(state.step), "losses": [losses[s] for s in sorted(losses)],
           "restarts": restarts["n"], "seconds": time.perf_counter() - t0,
           "step_s": times, "ckpt_dir": args.ckpt_dir, "last_ckpt": ckpt.latest_step()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()

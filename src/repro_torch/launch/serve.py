"""Serving command line: batched greedy/temperature generation on the card.

    # Yi-6B at its published widths, random weights, prefill through the
    # flash-attention kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --preset full \
        --requests 8 --prompt-len 2048 --max-new-tokens 32

    # Mamba-2 1.3B (no attention: the SSD prefill, a recurrent decode)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --preset full \
        --requests 4 --prompt-len 1024

    # Whisper-tiny: 30 s of frame embeddings (1500 frames), greedy decoding
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --preset full \
        --requests 4 --prompt-len 4 --max-new-tokens 32

    # The reduced same-family config on the CPU (plain attention)
    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke --device cpu

    # The weights of a training checkpoint (repro_torch.launch.train, the
    # same --arch, --preset and overrides)
    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke --device cpu \
        --ckpt-dir build/ckpt_smoke

    # Tensor and expert parallel on a (2, 2) ("data", "model") mesh of four
    # positions of the one card (any --arch)
    REPRO_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2-1.3b --preset full --model-parallel 2

Every config of ``--arch`` serves.  Decoder-only models serve text prompts
through ``ServeEngine`` (a VLM's token path; its image embeddings are a
stub, as in the JAX package); the encoder-decoder (whisper) encodes random
frame embeddings of ``ENC_FRAMES`` frames (30 s of audio at 50 frames/s)
and decodes greedily from a ``--prompt-len`` token prompt.  Random weights
from ``--seed`` (no pretrained weights ship with the repository), or with
``--ckpt-dir`` the parameters of the latest checkpoint there (cast to the
serving dtype); the model-surgery overrides of the train command line
(``--num-layers`` ...) shape the model as the run that wrote it.  A Mamba
prompt longer than the SSD chunk must be a multiple of it, and one that
decodes must hold at least ``ssm_conv - 1`` tokens.
``--model-parallel N`` (N > 1) serves every arch on the JAX package's
local mesh, ``(n // N, N)`` on ``("data", "model")`` over the ``n``
positions ``REPRO_DEVICES`` gives (``launch.mesh.build_local_mesh``): the
batch over ``data``; heads, ``d_ff``, Mamba's ``d_inner`` and SSM heads,
experts and vocabulary over ``model`` (``models.model.shard_params``).
Prints one JSON line: the model, the device it ran on, the mesh, the tokens
generated and the time they took.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.device import device_name, resolve_device
from repro_torch.launch.mesh import build_local_mesh
from repro_torch.launch.model_args import add_model_args, resolve_config
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import build_model, shard_params
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serve.engine import Request, ServeEngine

ENC_FRAMES = 1500  # whisper's encoder input: 30 s of audio at 50 frames/s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    cfg = resolve_config(args)
    dev = resolve_device(args.device)
    mesh = None
    if args.model_parallel != 1:
        try:
            mesh = build_local_mesh(args.model_parallel, device=dev)
        except ValueError as err:
            raise SystemExit(f"--model-parallel: {err}") from None
    model = build_model(cfg, device=dev, mesh=mesh,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    ckpt_step = None
    if args.ckpt_dir:
        if not os.path.isdir(args.ckpt_dir):
            raise SystemExit(f"--ckpt-dir: no checkpoint in {args.ckpt_dir} (no such directory)")
        ckpt = CheckpointManager(args.ckpt_dir, use_async=False)
        ckpt_step = ckpt.latest_step()
        if ckpt_step is None:
            raise SystemExit(f"--ckpt-dir: no checkpoint in {args.ckpt_dir}")
        like = params_to_jax(model, {n: p.to("meta") for n, p in model.named_parameters()})
        params_from_jax(model, ckpt.restore(ckpt_step, {"params": like})["params"])
    if mesh is not None:
        model = shard_params(model)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.requests, args.prompt_len))
    t0 = time.perf_counter()
    if cfg.is_encdec:
        if args.temperature > 0:
            raise SystemExit("--temperature: encoder-decoder archs decode greedily")
        frames = 0.02 * rng.standard_normal((args.requests, ENC_FRAMES, cfg.d_model))
        toks, wave = model.greedy(torch.as_tensor(frames, dtype=torch.float32),
                                  torch.as_tensor(prompts), args.max_new_tokens)
        outs, stats = toks.tolist(), [wave]
    else:
        engine = ServeEngine(model, temperature=args.temperature, seed=args.seed)
        outs = engine.serve([Request(prompt=p.tolist(), max_new_tokens=args.max_new_tokens)
                             for p in prompts])
        stats = engine.stats
    seconds = time.perf_counter() - t0
    new_tokens = sum(len(o) for o in outs)
    steps = sum(w["decode_steps"] for w in stats)
    out = {
        "arch": cfg.name, "family": cfg.family, "preset": args.preset,
        "device": device_name(dev), "mesh": None if mesh is None else mesh.shape,
        "dtype": str(model.dtype).removeprefix("torch."),
        "params": model.num_params(), "ckpt_step": ckpt_step, "requests": len(outs),
        "new_tokens": new_tokens, "seconds": seconds,
        "tokens_per_s": new_tokens / seconds,
        "prefill_s": [w["prefill_s"] for w in stats],
        "decode_ms_per_step": (1e3 * sum(w["decode_s"] for w in stats) / steps
                               if steps else None),
        "first_tokens": [o[:8] for o in outs[:4]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

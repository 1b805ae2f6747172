"""Serving command line: batched greedy/temperature generation on the card.

    # Yi-6B at its published widths, random weights, prefill through the
    # flash-attention kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --preset full \
        --requests 8 --prompt-len 2048 --max-new-tokens 32

    # The reduced same-family config on the CPU (plain attention)
    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke --device cpu

Random weights from ``--seed`` (no pretrained weights ship with the
repository).  Prints one JSON line: the model, the device it ran on, the
tokens generated and the time they took.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import device_name, resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise SystemExit("--model-parallel: the port serves on one card; model "
                         "parallelism waits for the mesh slice (ROADMAP.md)")
    if args.ckpt_dir:
        raise SystemExit("--ckpt-dir: checkpoints come with the training slice "
                         "(ROADMAP.md); the port serves random weights")

    cfg = get_config(args.arch) if args.preset == "full" else smoke_config(args.arch)
    dev = resolve_device(args.device)
    try:
        model = build_model(cfg, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed))
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    engine = ServeEngine(model, temperature=args.temperature, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist(),
                    max_new_tokens=args.max_new_tokens)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.serve(reqs)
    seconds = time.perf_counter() - t0
    new_tokens = sum(len(o) for o in outs)
    steps = sum(w["decode_steps"] for w in engine.stats)
    out = {
        "arch": cfg.name, "preset": args.preset, "device": device_name(dev),
        "dtype": str(model.dtype).removeprefix("torch."),
        "params": model.num_params(), "requests": len(reqs),
        "new_tokens": new_tokens, "seconds": seconds,
        "tokens_per_s": new_tokens / seconds,
        "prefill_s": [w["prefill_s"] for w in engine.stats],
        "decode_ms_per_step": (1e3 * sum(w["decode_s"] for w in engine.stats) / steps
                               if steps else None),
        "first_tokens": [o[:8] for o in outs[:4]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

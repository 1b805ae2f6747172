"""The model flags the train and serve command lines share: ``--arch``,
``--preset`` and the model-surgery overrides.  The serve command line
loads the train command line's checkpoints, so both shape the model the
same way from the same flags."""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config, smoke_config

SURGERY = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size")


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    for k in SURGERY:
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=None)


def resolve_config(args):
    """The config of ``--arch`` at ``--preset``, with the overrides given
    (and ``--microbatches``, where the command line has it)."""
    cfg = get_config(args.arch) if args.preset == "full" else smoke_config(args.arch)
    upd = {k: getattr(args, k) for k in SURGERY if getattr(args, k) is not None}
    if getattr(args, "microbatches", 1) > 1:
        upd["microbatches"] = args.microbatches
    return dataclasses.replace(cfg, **upd) if upd else cfg

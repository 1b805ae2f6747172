"""End to end on the PyTorch port: train a ~100M-parameter LM with
the full substrate (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py            # quick (20 steps), on the card
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --fail-at-step 150
    PYTHONPATH=src python examples/train_lm_torch.py --steps 2 --device cpu

The config is a qwen-family dense model sized to ~100M params.  Everything
is the production path: remat'd layers, AdamW, the deterministic resumable
pipeline, async checkpoints every 20 steps, the watchdog, the crash-restart
loop (``repro_torch.launch.train.main``).  ``--fail-at-step``
demonstrates fault tolerance: the run crashes once, the loop restores the
latest checkpoint, and training completes.  Without ``--ckpt-dir`` the
checkpoints go to a fresh temporary directory, named in the final line.
"""

import argparse
import sys

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    argv = [
        "--arch", "qwen1.5-0.5b", "--preset", "full",
        # surgery down to ~100M params (d=768, 12 layers, vocab 32k)
        "--num-layers", "12", "--d-model", "768", "--num-heads", "12",
        "--num-kv-heads", "12", "--d-ff", "2048", "--vocab-size", "32000",
        "--steps", str(args.steps), "--global-batch", "4",
        "--seq-len", "256", "--ckpt-every", "20",
        "--fail-at-step", str(args.fail_at_step),
        "--log-every", "5", "--device", args.device,
    ]
    if args.ckpt_dir is not None:
        argv += ["--ckpt-dir", args.ckpt_dir]
    metrics = train_mod.main(argv)
    print(f"final: {metrics}")
    return metrics


if __name__ == "__main__":
    sys.exit(0 if main() else 0)

"""Serve a small model with batched requests through the PyTorch port's
ServeEngine (the counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/serve_lm_torch.py               # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Requests with different prompt lengths are bucketed into waves; each wave
prefills its prompts (attention through the flash-attention kernel on the
card) into a cache allocated once at the wave's full length, then decodes
one token a step, writing the cache in place.  Works for every
decoder-only family — swap --arch for 'mamba2-1.3b' to serve the SSM
(state cache instead of KV).
"""

import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    model = build_model(cfg, device=resolve_device(args.device))  # random weights, seed 0
    engine = ServeEngine(model, temperature=args.temperature)

    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                max_new_tokens=12)
        for n in (8, 8, 8, 16, 16, 24, 24, 24)
    ]
    t0 = time.time()
    outs = engine.serve(reqs)
    dt = time.time() - t0
    for i, (r, o) in enumerate(zip(reqs, outs)):
        print(f"req {i}: prompt_len={len(r.prompt):>2d} -> {o}")
    n_new = sum(len(o) for o in outs)
    print(f"{len(reqs)} requests / {n_new} new tokens in {dt:.2f}s "
          f"({n_new/dt:.1f} tok/s incl. the kernel build)")


if __name__ == "__main__":
    main()

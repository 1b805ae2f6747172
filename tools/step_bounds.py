"""Re-derive the step bounds PERF.md worked out by hand, with the dry run's
accounting: each step counted on ``meta`` tensors
(``repro_torch.analysis.op_analysis.analyze_step``) and bounded by
``roofline_terms`` at the H100's rates (989 TFLOP/s bf16, 3.35 TB/s HBM).
Derived, not measured: no card runs here.

* phase 12's qwen1.5-0.5b train step: one device, 8 x 2048, float32
  masters, bf16 compute, remat full;
* phase 15's mamba2-1.3b train step on (2, 2) positions: 4 x 2048, its
  config (fsdp, remat full, bf16);
* phase 7's yi-6b decode step: bf16 weights, 4 requests at cursor 2079 of
  a 2080-slot cache (a 2048 wave and its 32 new tokens).

    PYTHONPATH=src python tools/step_bounds.py
"""

from __future__ import annotations

import json
import time

import torch

from repro_torch.analysis.op_analysis import analyze_step
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.dist import make_mesh
from repro_torch.models import build_model
from repro_torch.models.model import shard_params
from repro_torch.train import AdamWConfig, make_train_step, train_state_shapes


def train_cell(arch: str, batch: int, seq: int, mesh_shape=None) -> dict:
    cfg = get_config(arch)
    shape = ShapeConfig("step", seq, batch, "train")
    n = 1
    mesh = None
    if mesh_shape is not None:
        n = mesh_shape[0] * mesh_shape[1]
        mesh = make_mesh(mesh_shape, ("data", "model"), devices=["meta"] * n)
    model = build_model(cfg, device="meta", dtype=torch.float32, compute_dtype=cfg.dtype,
                        mesh=mesh)
    opt = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    state = train_state_shapes(model, opt, mesh)
    rec = analyze_step(make_train_step(model, opt, mesh=mesh), state, model.input_specs(shape),
                       num_partitions=n)
    return _terms(rec, model_flops(model.cfg, shape), n)


def decode_cell(arch: str, batch: int, cache: int) -> dict:
    cfg = get_config(arch)
    model = build_model(cfg, device="meta", dtype=torch.bfloat16)
    caches = model.new_caches(batch, cache, device="meta")
    tokens = torch.empty((batch, 1), dtype=torch.int64, device="meta")
    rec = analyze_step(lambda t, c: model.serve_step(t, cache - 1, c), tokens, caches)
    shape = ShapeConfig("step", cache, batch, "decode")
    return _terms(rec, model_flops(model.cfg, shape), 1)


def _terms(rec: dict, mf: float, n: int) -> dict:
    coll = rec["collectives"]["operand_bytes"]
    roof = roofline_terms(flops_per_device=rec["flops"], bytes_per_device=rec["bytes"],
                          collective_operand_bytes=coll, n_devices=n, model_flops_global=mf)
    bound_ms = 1e3 * max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    return dict(flops=rec["flops"], bytes=rec["bytes"], collective_operand_bytes=coll,
                memory=rec["memory"], roofline=roof, bound_ms=bound_ms)


def main() -> None:
    cells = {"qwen1.5-0.5b train 8 x 2048, one device": lambda: train_cell("qwen1.5-0.5b", 8, 2048),
             "mamba2-1.3b train 4 x 2048 on (2, 2)": lambda: train_cell("mamba2-1.3b", 4, 2048,
                                                                        (2, 2)),
             "yi-6b decode step, 4 x 2080 slots": lambda: decode_cell("yi-6b", 4, 2080)}
    for name, fn in cells.items():
        t0 = time.perf_counter()
        rec = fn()
        rec["count_s"] = time.perf_counter() - t0
        print(json.dumps({"cell": name, **rec}), flush=True)


if __name__ == "__main__":
    main()

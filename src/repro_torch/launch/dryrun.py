"""The dry run: count every (arch x shape x mesh) cell's step on the
production mesh, without a card (port of ``repro.launch.dryrun``).

The JAX dry run AOT-lowers ``train_step`` / ``prefill`` / ``serve_step``
against ShapeDtypeStructs, compiles for the production mesh and reads XLA's
analyses of the compiled program.  The port has no compiled program: it
runs its own eager step on ``meta`` tensors (shapes and dtypes, nothing
allocated) over :func:`~repro_torch.launch.mesh.make_production_mesh`, a
mesh of ``meta`` positions, under the cost counter of
:mod:`repro_torch.analysis.op_analysis`, and records

* ``memory``: the arguments a position (exact, from position 0's shards of
  the state or the weights, and its share of the batch and caches), the
  outputs, temporaries and donated bytes, and ``total_hbm_bytes``, the
  peak of the live bytes over the mesh divided by its positions;
* ``cost``: per-device flops (every matmul, and the flash kernel's charge
  at each of its calls) and HBM bytes (every op's inputs and outputs; the
  kernels' own counts);
* ``collectives``: the operand and wire bytes of every collective of the
  meshed model, by kind, per device;
* ``roofline``: the three terms at the H100's rates
  (:mod:`repro_torch.analysis.roofline`).

A train cell runs ``make_train_step(model, opt_cfg, mesh=)`` on
``train_state_shapes`` (float32 masters, ``cfg.dtype`` compute, the state
donated as JAX donates it); a serve cell ``prefill`` or one ``serve_step``
of the meshed model, its weights in ``cfg.dtype``, the decode step at the
last slot of a cache of ``seq_len`` (its attention reads every slot, as
JAX's traced cursor does).  Each position holds the block of every cache
leaf that ``cache_specs`` (JAX's ``_cache_specs``) gives it: the KV heads
over ``model`` where they divide, else the sequence, which a decode step
then attends over slice by slice, the partial softmaxes combined by a
``pmax`` and two ``psum`` reductions over the sequence's axes (counted with
the other collectives).  A batch that does not divide over the batch axes
(``long_500k``'s one row) is replicated over them, as JAX's
``input_shardings`` leave it, and the caches' sequence is spread over
those axes too.  A prefill or train cell of a config with
``seq_shard_activations`` holds each position's slice of the residual
between blocks (JAX's ``constrain_residual``): its live bytes and its
collectives (reduce-scatters and all-gathers where the psums were) are
JAX's layout's, and its inputs are counted by their ``input_shardings``
blocks.

Records go to ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``, so the
two packages' records never overwrite each other, with JAX's keys but:
``trace_s`` (the seconds of the counted step) for ``lower_s`` and
``compile_s``; no ``cost_xla`` (XLA's own ``cost_analysis``), no
``cost_raw_f32`` (the port counts true dtypes: there is no CPU float
normalisation to correct) and no ``hlo_bytes`` (there is no HLO);
``--keep-ops`` (each op's bytes, flops and model line, for
:mod:`repro_torch.analysis.op_top`) for ``--keep-hlo``.  The cost of the
dry run is the Python meta implementation of every op, once a position:
minutes for a full train cell on 256 positions, as compile time is JAX's.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.op_analysis import analyze_step
from repro_torch.analysis.roofline import model_flops, param_counts, roofline_terms
from repro_torch.configs import SHAPES, REGISTRY, get_config, get_shape, shape_applicable
from repro_torch.dist.sharding import mesh_extent
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model import mesh_model, shard_leaves
from repro_torch.train import AdamWConfig, make_train_step, train_state_shapes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def _apply_overrides(cfg, overrides: dict):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict or list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_bytes(x) for x in items)


def input_block_bytes(batch: dict, specs: dict, mesh) -> int:
    """A position's bytes of the inputs ``batch`` laid out by ``specs``
    (``input_shardings``): each input's block, as JAX counts an argument
    (the batch over the batch axes, ``embeds`` over ``model`` too where the
    residual is sequence-sharded)."""
    total = 0
    for name, t in batch.items():
        n = t.numel() * t.element_size()
        for entry in specs[name]:
            n //= mesh_extent(mesh, entry)
        total += n
    return total


def train_state_bytes(model, opt_cfg: AdamWConfig, mesh) -> int:
    """A position's bytes of ``train_state_shapes(model, opt_cfg, mesh)``,
    by arithmetic on the blocks ``param_specs`` lays out (no state built):
    a parameter's block in its dtype, two moments' in the moment dtype, two
    int32 counters."""
    meshed = mesh_model(model, mesh)
    per = (torch.empty((), dtype=model.param_dtype).element_size()
           + 2 * torch.empty((), dtype=getattr(torch, opt_cfg.moment_dtype)).element_size())
    total = 0
    for name, shape in meshed.shapes.items():
        spec = tuple(meshed.spec(name)) + (None,) * len(shape)
        n = 1
        for d, e in zip(shape, spec):
            n *= d if e is None else d // mesh_extent(mesh, e)
        total += n * per
    return total + 2 * 4


def build_cell(arch: str, shape_name: str, mesh, overrides: dict | None = None):
    """-> (fn, args, argument bytes a position, step kind, model): ``fn(*args)``
    is the cell's step on ``meta`` tensors."""
    cfg = _apply_overrides(get_config(arch), overrides or {})
    shape = get_shape(shape_name)
    if shape.kind == "train":
        model = build_model(cfg, device="meta", dtype=torch.float32, compute_dtype=cfg.dtype,
                            mesh=mesh)
        opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
        state = train_state_shapes(model, opt_cfg, mesh)
        batch = model.input_specs(shape)
        arg = (train_state_bytes(model, opt_cfg, mesh)
               + input_block_bytes(batch, model.input_shardings(shape), mesh))
        step = make_train_step(model, opt_cfg, mesh=mesh, donate=True)
        return step, (state, batch), arg, "train_step", model
    model = build_model(cfg, device="meta", mesh=mesh)
    meshed = mesh_model(model, mesh)
    if shape.global_batch % meshed.ctx.n_batch:  # JAX replicates such a batch
        meshed = meshed.with_batch_replicated()
    # a copy of every block a position, as each card of the mesh holds one
    meshed.shards = shard_leaves(meshed, model.flat_params())
    batch = meshed.input_specs(shape)
    n_batch = meshed.ctx.n_batch
    if shape.kind == "prefill":
        def prefill(shards, batch):
            return meshed.with_shards(shards).prefill(**batch)

        arg = _bytes(meshed.shards[0]) + input_block_bytes(batch, model.input_shardings(shape),
                                                           mesh)
        return prefill, (meshed.shards, batch), arg, "prefill", model
    pos = shape.seq_len - 1

    def serve_step(shards, tokens, caches):
        return meshed.with_shards(shards).serve_step(tokens, pos, caches)

    caches = batch["caches"]
    arg = _bytes(meshed.shards[0]) + _bytes(batch["tokens"]) // n_batch + _bytes(caches[0])
    return serve_step, (meshed.shards, batch["tokens"], caches), arg, "serve_step", model


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, force: bool = False,
             keep_ops: bool = False, overrides: dict | None = None, tag: str = "") -> dict:
    name = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, mesh_kind, f"{name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "skipped" if not ok else "pending",
    }
    if not ok:
        rec["skip_reason"] = reason
        _save(path, rec)
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    if overrides:
        rec["overrides"] = dict(overrides)
    try:
        fn, args, arg_bytes, step_kind, model = build_cell(arch, shape_name, mesh, overrides)
        t0 = time.time()
        hc = analyze_step(fn, *args, num_partitions=n_dev, argument_bytes=arg_bytes,
                          keep_ops=keep_ops)
        t1 = time.time()
        coll = hc["collectives"]
        n_total, n_active = param_counts(model.cfg)
        mf = model_flops(model.cfg, shape)
        roof = roofline_terms(
            flops_per_device=float(hc["flops"]),
            bytes_per_device=float(hc["bytes"]),
            collective_operand_bytes=float(coll["operand_bytes"]),
            n_devices=n_dev,
            model_flops_global=mf,
        )
        rec.update(
            status="ok",
            step_kind=step_kind,
            n_devices=n_dev,
            mesh_shape={k: int(v) for k, v in mesh.shape.items()},
            params_total=float(model.num_params()),
            params_matmul_total=float(n_total),
            params_matmul_active=float(n_active),
            trace_s=round(t1 - t0, 2),
            cost={"flops": float(hc["flops"]), "bytes": float(hc["bytes"])},
            memory=hc["memory"],
            collectives=coll,
            roofline=roof,
            kernels=hc["kernels"],
        )
        if keep_ops:
            op_path = path[:-5] + ".ops.json"
            os.makedirs(os.path.dirname(op_path), exist_ok=True)
            with open(op_path, "w") as f:
                json.dump(hc["ops"], f)
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec.update(status="error", error=repr(e), trace=traceback.format_exc())
    _save(path, rec)
    return rec


def _save(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def _summary_line(rec: dict) -> str:
    tag = f"{rec['arch']:<24s} {rec['shape']:<12s} {rec['mesh']:<6s}"
    if rec["status"] == "skipped":
        return f"{tag} SKIP  ({rec['skip_reason'][:60]}...)"
    if rec["status"] == "error":
        return f"{tag} ERROR {rec['error'][:90]}"
    r = rec["roofline"]
    mem = rec.get("memory", {}).get("total_hbm_bytes")
    memgb = f"{mem/2**30:7.2f}GiB" if mem else "      n/a"
    return (
        f"{tag} ok    comp={r['compute_s']:9.3e}s mem={r['memory_s']:9.3e}s "
        f"coll={r['collective_s']:9.3e}s dom={r['dominant'][:-2]:<10s} "
        f"hbm/dev={memgb} useful={r['useful_flops_ratio']:5.2f} "
        f"trace={rec['trace_s']:.0f}s"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="full matrix")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    ap.add_argument("--keep-ops", action="store_true",
                    help="also write <cell>.ops.json, each op's record, for op_top")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (repeatable)")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.overrides)

    archs = sorted(REGISTRY) if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape in (None, "all")) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_bad = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(
                    arch, shape_name, mesh_kind, args.out,
                    force=args.force, keep_ops=args.keep_ops,
                    overrides=overrides, tag=args.tag,
                )
                print(_summary_line(rec), flush=True)
                n_bad += rec["status"] == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} cells failed")


if __name__ == "__main__":
    main()

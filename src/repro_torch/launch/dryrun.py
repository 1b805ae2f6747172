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
:mod:`repro_torch.analysis.op_top`) for ``--keep-hlo``.

The count is trip-aware, as ``analyze_hlo``'s is: JAX scans a stack of L
layers as L / P groups (P = ``attn_period`` for the hybrid family, else 1)
and the microbatches of a train step, and counts each scan body once,
times its trips.  An eager step has no scan body, so the port counts the
step at two depths ``d1`` (the fewest whole groups of at least two layers)
and ``d2 = d1 + P`` and extends every additive quantity (flops, bytes,
each collective kind's count and bytes, each kernel's calls, flops and
bytes, argument, output and donated bytes) along the line through them to
L; a train step of m > 2 microbatches is counted at two, its second
microbatch's ops then taken m - 2 more times.  The peak is the largest of
its phases' (each run of forward ops, of backward ops), each extended on
its own line.  Whisper's two stacks of 4 layers are counted whole.  The
record's ``counted_depths`` names the depths counted, ``counts`` each
count's depth, microbatches and seconds, ``trace_s`` their sum.
``--full-count`` (and ``--keep-ops``, whose op list is the whole step's)
counts the step at its full depth, the witness of the trip-aware count;
``compare_records`` holds two records of a cell to each other.  A count's
cost is the Python meta implementation of every op, once a position; the
counter runs each op's meta implementation once a signature
(``op_analysis._run_meta``), since every position repeats it.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --full-count
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
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import mesh_extent
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model import mesh_model, shard_leaves
from repro_torch.models.transformer import group_pattern
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


def build_cell(arch: str | ModelConfig, shape_name: str | ShapeConfig, mesh,
               overrides: dict | None = None):
    """-> (fn, args, argument bytes a position, step kind, model): ``fn(*args)``
    is the cell's step on ``meta`` tensors (``arch`` a registered id or a
    config, ``shape_name`` a shape id or a shape)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    cfg = _apply_overrides(cfg, overrides or {})
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
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


# -- the trip-aware count --------------------------------------------------------


def trip_depths(cfg: ModelConfig) -> tuple | None:
    """The two depths a trip-aware count counts ``cfg``'s stack at: ``d1``,
    the fewest whole groups (JAX's scan body, ``group_pattern``:
    ``attn_period`` layers for the hybrid family, else one) of at least two
    layers (the first layer's peak is not on the line through the others:
    its input is the embedding's), and ``d2 = d1 + P``.  ``None`` where the
    stack is no deeper than ``d2``, and for whisper, whose two stacks of 4
    layers are counted whole (a count a stack would run more layers)."""
    if cfg.is_encdec:
        return None
    p = len(group_pattern(cfg))
    d1 = p * -(-2 // p)
    return (d1, d1 + p) if cfg.num_layers > d1 + p else None


def scaled_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """A train step of more than two microbatches (JAX's ``lax.scan`` over
    them) is counted at two, each of the batch's microbatches' rows, and
    its second microbatch's ops (a phase of forward ops, the first's
    gradient sum at its head, and one of backward ops) taken as many more
    times as there are microbatches more (one microbatch takes another
    path: no sums)."""
    return shape.kind == "train" and cfg.microbatches > 2


def count_plan(cfg: ModelConfig, shape: ShapeConfig, full: bool = False) -> list:
    """``[(config, shape), ...]``: the counts of a trip-aware count, the
    stack at each of ``trip_depths``, at two microbatches where
    ``scaled_microbatches``; ``[(cfg, shape)]``, the full count, with
    ``full`` or where neither applies."""
    depths = trip_depths(cfg)
    micro = scaled_microbatches(cfg, shape)
    if full or depths is None and not micro:
        return [(cfg, shape)]
    upd, at = {}, shape
    if micro:
        upd["microbatches"] = 2
        at = dataclasses.replace(shape, global_batch=shape.global_batch // cfg.microbatches * 2)
    return [(dataclasses.replace(cfg, num_layers=d, **upd), at)
            for d in depths or (cfg.num_layers,)]


def _combine(recs: list, weights: list):
    """``sum(w * rec)`` leaf by leaf; a key a record lacks is 0 there (a
    dict: an empty one).  Integer weights keep integers integers."""
    if any(isinstance(r, dict) for r in recs):
        keys = dict.fromkeys(k for r in recs for k in (r or {}))
        return {k: _combine([(r or {}).get(k, 0) for r in recs], weights) for k in keys}
    return sum(w * r for w, r in zip(weights, recs))


def _line_weights(depths: tuple, full: int) -> list:
    """The weights of the counts at ``depths = (d1, d2)`` in the line's
    value at ``full``: ``1 - x`` and ``x``, ``x = (full - d1) / (d2 -
    d1)``, a whole number."""
    d1, d2 = depths
    x, rest = divmod(full - d1, d2 - d1)
    if rest:
        raise ValueError(f"num_layers={full} is not a whole number of {d2 - d1}-layer groups")
    return [1 - x, x]


_ADDITIVE = ("flops", "bytes", "collectives", "kernels")


def _more_microbatches(rec: dict, more: int, batch_block: int, batch_live: int) -> dict:
    """A count of two microbatches -> the count of ``2 + more``: its
    second microbatch's phases (the third and fourth: the first's gradient
    sum and the forward, then the backward) ``more`` times more, the
    arguments and every phase's peak ``more`` microbatches' rows of the
    batch (``batch_block`` a position's block, ``batch_live`` its share of
    the live bytes) more.  The phases are those of the train step's
    ``accumulate`` (``repro_torch.train.train_step``), which sums each
    microbatch's gradients as it runs the next: both microbatches' backward
    phases must then be the same ops."""
    phases = rec["phases"]
    if len(phases) != 5:
        raise ValueError(f"a train step of two microbatches ran {len(phases)} phases, not "
                         f"the 5 of forward and backward twice, then the update")
    first, second = _leaves(phases[1]), _leaves(phases[3])
    if first.keys() != second.keys() or any(
            abs(second[k] - v) > 1e-9 * abs(v) for k, v in first.items()):
        raise ValueError("the two microbatches' backward phases differ: the train step no "
                         "longer runs a microbatch as a forward, then a backward phase")
    body = _combine([phases[2], phases[3]], [1, 1])
    body["collectives"]["operand_bytes"] = sum(
        v["operand_bytes"] for v in body["collectives"]["by_type"].values())
    body["collectives"]["wire_bytes"] = sum(
        v["wire_bytes"] for v in body["collectives"]["by_type"].values())
    out = dict(rec)
    for key in _ADDITIVE:
        out[key] = _combine([rec[key], body[key]], [1, more])
    out["collectives"]["num_static_sites"] = rec["collectives"]["num_static_sites"]
    out["memory"] = dict(rec["memory"])
    out["memory"]["argument_size_in_bytes"] += more * batch_block
    out["phase_peaks"] = [p + more * batch_live for p in rec["phase_peaks"]]
    return out


def scale_counts(cfg: ModelConfig, shape: ShapeConfig, recs: list, batches: list) -> dict:
    """``analyze_step``'s records at ``count_plan(cfg, shape)``'s counts
    (``batches``: each count's batch bytes, a position's block and live
    share, of one microbatch) -> the record at ``cfg``'s own depth and
    microbatches.  Each count is first taken to the config's microbatches
    (:func:`_more_microbatches`); then every quantity is extended along the
    line through the two depths, ``q(L) = q(d1) + (L - d1) / (d2 - d1) *
    (q(d2) - q(d1))``, exact for a quantity affine in the depth.  The
    static collective sites are the deepest count's (a site is a line of
    the model, at any depth).  The peak is the largest of the phases' peaks
    (each run of forward ops and of backward ops: a train step's forward,
    backward and update grow at their own rates), each extended on its own
    line; the temporaries are re-derived so that ``total = argument +
    output + temp - alias``."""
    if len(recs) == 1 and not batches[0]:
        return recs[0]
    more = cfg.microbatches - 2 if scaled_microbatches(cfg, shape) else 0
    if more:
        recs = [_more_microbatches(r, more, *b) for r, b in zip(recs, batches)]
    depths = trip_depths(cfg)
    weights = _line_weights(depths, cfg.num_layers) if depths else [1]
    bare = [{k: v for k, v in r.items() if k not in ("phase_peaks", "phases")} for r in recs]
    out = _combine(bare, weights)
    out["num_partitions"] = recs[0]["num_partitions"]
    out["collectives"]["num_static_sites"] = max(r["collectives"]["num_static_sites"]
                                                 for r in recs)
    peaks = [r["phase_peaks"] for r in recs]
    if len({len(p) for p in peaks}) != 1:  # the phases differ: the whole step's
        peaks = [[max(r["phase_peaks"])] for r in recs]
    out["phase_peaks"] = [_combine(list(p), weights) for p in zip(*peaks)]
    mem = out["memory"]
    mem["total_hbm_bytes"] = max(out["phase_peaks"])
    mem["temp_size_in_bytes"] = max(mem["total_hbm_bytes"] - mem["argument_size_in_bytes"]
                                    - mem["output_size_in_bytes"]
                                    + mem["alias_size_in_bytes"], 0)
    return out


def _batch_bytes(batch: dict, model, shape: ShapeConfig, mesh, micro: int) -> tuple:
    """A train batch of ``micro`` microbatches -> one microbatch's bytes:
    a position's block of it, and its share of the distinct storages."""
    block = input_block_bytes(batch, model.input_shardings(shape), mesh)
    live = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in batch.values()}.values())
    return block // micro, live // (mesh.size * micro)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, full: bool = False,
               keep_ops: bool = False) -> tuple:
    """Count ``cfg``'s ``shape`` step on ``mesh``, trip-aware or, with
    ``full`` or ``keep_ops`` (whose op list is the whole step's), in full
    -> (``analyze_step``'s record at ``cfg``'s depth and microbatches, each
    count's ``{num_layers, microbatches (a train step's), trace_s}``, the
    step kind, the full-depth model)."""
    plan = count_plan(cfg, shape, full or keep_ops)
    scaled = plan != [(cfg, shape)]
    fields = ["num_layers"] + (["microbatches"] if shape.kind == "train" else [])
    recs, batches, counts, kind, model = [], [], [], None, None
    for at_cfg, at_shape in plan:
        fn, args, arg_bytes, kind, model = build_cell(at_cfg, at_shape, mesh)
        t0 = time.time()
        recs.append(analyze_step(fn, *args, num_partitions=mesh.size,
                                 argument_bytes=arg_bytes, keep_ops=keep_ops))
        counts.append({**{f: getattr(at_cfg, f) for f in fields},
                       "trace_s": round(time.time() - t0, 2)})
        batches.append(_batch_bytes(args[1], model, at_shape, mesh, at_cfg.microbatches)
                       if scaled and scaled_microbatches(cfg, shape) else ())
        del fn, args
    if scaled:
        model = build_model(cfg, device="meta", mesh=mesh)
    return scale_counts(cfg, shape, recs, batches), counts, kind, model


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, force: bool = False,
             keep_ops: bool = False, overrides: dict | None = None, tag: str = "",
             full_count: bool = False) -> dict:
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
        cfg = _apply_overrides(cfg, overrides or {})
        hc, counts, step_kind, model = count_cell(cfg, shape, mesh, full=full_count,
                                                  keep_ops=keep_ops)
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
            trace_s=round(sum(c["trace_s"] for c in counts), 2),
            counted_depths=list(dict.fromkeys(c["num_layers"] for c in counts)),
            counts=counts,
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


# a record's fields that say how it was counted, not what
_HOW = {"trace_s", "counted_depths", "counts", "overrides", "status"}


def _leaves(rec: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def compare_records(a: dict, b: dict) -> dict:
    """Two records of one cell (say a scaled count and a full one) ->
    ``{field: (a's, b's)}`` of every field that differs: an integer at all,
    a float by more than ``1e-9`` of ``b``'s; the fields of how each was
    counted left out."""
    la = _leaves({k: v for k, v in a.items() if k not in _HOW})
    lb = _leaves({k: v for k, v in b.items() if k not in _HOW})
    out = {}
    for key in la.keys() | lb.keys():
        x, y = la.get(key), lb.get(key)
        if isinstance(x, float) and isinstance(y, float):
            if abs(x - y) > 1e-9 * abs(y):
                out[key] = (x, y)
        elif x != y:
            out[key] = (x, y)
    return out


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
        f"trace={rec['trace_s']:.0f}s depths={rec['counted_depths']}"
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
                    help="also write <cell>.ops.json, each op's record, for op_top "
                         "(counts the step at its full depth)")
    ap.add_argument("--full-count", action="store_true",
                    help="count the step at its full depth (the witness of the trip-aware "
                         "count)")
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
                    overrides=overrides, tag=args.tag, full_count=args.full_count,
                )
                print(_summary_line(rec), flush=True)
                n_bad += rec["status"] == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} cells failed")


if __name__ == "__main__":
    main()

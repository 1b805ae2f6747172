"""The dry run's trip-aware count (``repro_torch.launch.dryrun.count_cell``)
against its full count, as JAX's ``analyze_hlo`` counts a scanned layer
stack's body once and multiplies it by the trips.

One config of each family at small widths, with the production ``remat``
(full), ``fsdp`` and ``seq_shard_activations`` turned back on (the smoke
configs turn them off) and llama4's microbatches kept (4: counted at 2,
the second's ops taken twice more), on a (2, 2) mesh of ``meta``
positions: a train step, a prefill and a decode step, at 4 groups (jamba:
3 superblocks of 8 layers), counted trip-aware (at 2 and 3 groups; jamba
at 8 and 16 layers) and in full.  The additive fields agree within ``rel
1e-9``, the argument, output and donated bytes exactly, and the peak
exactly: each phase's peak (a run of forward or of backward ops) is affine
in the depth from two groups on, and the scaled count takes the largest of
the phases' lines.  Whisper (4 encoder and 4 decoder layers) is counted
whole: its count is the full count.  ``test_torch_dryrun_scaled_cli.py``
holds the groups to JAX's scan and the command line's record."""

import dataclasses

import pytest

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.meshes import make_mesh
from repro_torch.launch.dryrun import _leaves, count_cell, scaled_microbatches, trip_depths
from repro_torch.models.transformer import group_pattern

FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "llama4-scout-17b-a16e", "ssm": "mamba2-1.3b",
            "hybrid": "jamba-1.5-large-398b", "encdec": "whisper-tiny", "vlm": "qwen2-vl-2b"}
GROUPS = {"hybrid": 3}  # jamba's superblock is 8 layers
MESH = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
SEQ, ROWS = 32, 4
REL = 1e-9


def _config(family: str):
    base = smoke_config(FAMILIES[family])
    n = GROUPS.get(family, 4)
    upd = dict(remat="full", fsdp=True, seq_shard_activations=True,
               microbatches=4 if family == "moe" else 1)
    if not base.is_encdec:
        upd["num_layers"] = n * len(group_pattern(base))
    return dataclasses.replace(base, **upd)


EXACT = {"memory.argument_size_in_bytes", "memory.output_size_in_bytes",
         "memory.alias_size_in_bytes", "memory.total_hbm_bytes", "memory.temp_size_in_bytes",
         "num_partitions", "collectives.num_static_sites"}


def _assert_same_count(scaled: dict, full: dict) -> None:
    a, b = _leaves(scaled), _leaves(full)
    for rec in (a, b):  # each phase's record: the scaled count's own terms
        rec.pop("phase_peaks")
        rec.pop("phases", None)
    assert set(a) == set(b)
    for key, want in b.items():
        if key in EXACT or key.endswith(".count") or key.endswith(".calls"):
            assert a[key] == want, key
        else:
            assert a[key] == pytest.approx(want, rel=REL, abs=0.0), key


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_scaled_count_equals_the_full_count(family, kind):
    cfg = _config(family)
    rows = ROWS * cfg.microbatches if kind == "train" else ROWS
    shape = ShapeConfig(kind, SEQ, rows, kind)
    micro = scaled_microbatches(cfg, shape)
    assert micro == (family == "moe" and kind == "train")
    scaled, counts, _, model = count_cell(cfg, shape, MESH)
    assert model.cfg == cfg
    if cfg.is_encdec:  # whisper's count is the full count
        assert trip_depths(cfg) is None
        assert [c["num_layers"] for c in counts] == [cfg.encoder_layers + cfg.decoder_layers]
        assert scaled["flops"] > 0 and scaled["memory"]["total_hbm_bytes"] > 0
        return
    p = len(group_pattern(cfg))
    assert trip_depths(cfg) == ((8, 16) if p == 8 else (2, 3))
    assert [c["num_layers"] for c in counts] == list(trip_depths(cfg))
    assert all(c.get("microbatches") == 2 for c in counts) if micro else True
    full, whole, _, _ = count_cell(cfg, shape, MESH, full=True)
    assert len(whole) == 1 and whole[0]["num_layers"] == cfg.num_layers
    _assert_same_count(scaled, full)

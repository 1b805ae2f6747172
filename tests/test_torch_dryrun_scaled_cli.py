"""The dry run's trip-aware count (``repro_torch.launch.dryrun``): its
groups against JAX's scan bodies, the depths and microbatches it counts
every published config at, the line's weights, and the command line's
record against ``--full-count`` on a production cell."""

import dataclasses
import json

import pytest

from repro.configs import get_config as jax_get_config
from repro.models.transformer import group_pattern as jax_group_pattern

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import count_plan, scaled_microbatches, trip_depths
from repro_torch.models.transformer import group_pattern


def test_a_depth_override_changes_only_the_depth():
    """jamba's superblock repeats from layer 0 at every counted depth (its
    attention at offset 4, MoE on odd layers, JAX's pattern), with d / 8
    times the group's 4 MoE layers."""
    cfg = get_config("jamba-1.5-large-398b")
    jax_pattern = jax_group_pattern(jax_get_config(cfg.name))
    for depth in trip_depths(cfg):
        at = dataclasses.replace(cfg, num_layers=depth)
        assert group_pattern(at) == list(jax_pattern)
        kinds = [(at.layer_kind(i), at.ffn_kind(i)) for i in range(depth)]
        assert kinds == list(jax_pattern) * (depth // 8)
        assert sum(f == "moe" for _, f in kinds) == depth // 8 * 4
        assert dataclasses.replace(at, num_layers=cfg.num_layers) == cfg


@pytest.mark.parametrize("arch", list_archs())
def test_groups_are_jaxs_scan_groups(arch):
    """A group is JAX's scan body, its ``group_pattern``: every published
    decoder-only depth is a whole number of groups, more than the counted
    depths ``d1 < d2 = d1 + P``; whisper's two stacks are counted whole.
    Every published config's count is trip-aware but whisper's, and
    ``full`` gives the full count."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape_kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(shape_kind, 4096, 256, shape_kind)
        micro = scaled_microbatches(cfg, shape)
        assert micro == (shape_kind == "train" and cfg.microbatches > 2)
        plan = count_plan(cfg, shape)
        assert count_plan(cfg, shape, full=True) == [(cfg, shape)]
        if cfg.is_encdec:
            assert trip_depths(cfg) is None and plan == [(cfg, shape)]
            continue
        p = len(jax_group_pattern(jcfg))
        d1, d2 = trip_depths(cfg)
        assert d1 % p == 0 and d2 == d1 + p and d1 >= 2
        assert d2 < cfg.num_layers and (cfg.num_layers - d1) % p == 0
        assert [c.num_layers for c, _ in plan] == [d1, d2]
        assert all(c.microbatches == (2 if micro else cfg.microbatches) for c, _ in plan)


def test_corner_weights_are_the_multilinear_extension():
    """The counts' weights along the line through ``d1`` and ``d2`` (the
    one-axis multilinear extension) give an affine quantity's value at the
    full depth exactly; a depth that is no whole number of groups raises."""
    w = dryrun._line_weights((8, 16), 72)
    assert w == [-7, 8] and sum(w) == 1
    q = [3 + 5 * L for L in (8, 16)]
    assert sum(wi * qi for wi, qi in zip(w, q)) == 3 + 5 * 72
    assert dryrun._line_weights((2, 3), 24) == [-21, 22]
    with pytest.raises(ValueError, match="whole number"):
        dryrun._line_weights((8, 16), 70)


def _rec(tmp_path, *flags):
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single",
                 "--set", "num_layers=6", "--out", str(tmp_path), *flags])
    path = tmp_path / "single" / "qwen1.5-0.5b__decode_32k.json"
    return json.loads(path.read_text())


def test_command_line_records_the_counted_depths_and_full_count(tmp_path, capsys):
    """A production cell: the record names the counted depths and each
    count's seconds; ``--full-count`` gives the full record, and the two
    agree field by field (``compare_records``: floats within ``1e-9``,
    integers exact), as a mangled field shows."""
    scaled = _rec(tmp_path)
    assert scaled["status"] == "ok" and scaled["counted_depths"] == [2, 3]
    assert [c["num_layers"] for c in scaled["counts"]] == [2, 3]
    assert scaled["trace_s"] == pytest.approx(sum(c["trace_s"] for c in scaled["counts"]),
                                              abs=0.02)
    full = _rec(tmp_path, "--force", "--full-count")
    assert full["counted_depths"] == [6] and len(full["counts"]) == 1
    assert "depths=[2, 3]" in capsys.readouterr().out
    assert set(scaled) == set(full)
    assert dryrun.compare_records(scaled, full) == {}
    off = json.loads(json.dumps(scaled))
    off["memory"]["total_hbm_bytes"] += 1
    off["cost"]["flops"] *= 1 + 1e-8
    assert set(dryrun.compare_records(off, full)) == {"memory.total_hbm_bytes", "cost.flops"}

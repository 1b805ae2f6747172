#!/usr/bin/env python3
"""Plant faults in the flash-attention kernel and show which of
``chip_smoke.py``'s checks catch them.

    python3 tools/flash_planted_faults.py

For each fault below the script copies the port's package into a temporary
directory, edits that copy of ``csrc/flash_attention.cu`` (the checkout is
never changed), builds it (one ``nvcc`` per copy, all at once) and runs it
through the port's wrapper at the bf16 shapes the Yi-6B serve path gives the
kernel, held to ``ref.flash_attention`` by ``chip_smoke.flash_errors``. It
prints, per fault and shape, the max abs error, the max per-row relative
error, and whether the JAX kernel tests' elementwise tolerance alone
(``rtol=atol=3e-2``) and the full check (that and the per-row bound) pass.
Exits 1 unless the unchanged kernel passes the full check at every shape
and every fault fails it at some shape. Needs one card.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Every fault edits the bf16 (wgmma) body, the one the serve path runs. None
# of them stalls the K/V ring: a skipped tile is still waited for and
# released, and a shorter loop shortens the producer's and the consumers'
# loops alike.
TILES = "const int ntiles = (kend + kWgBKV - 1) / kWgBKV;"
FULL_WAIT = "mbar_wait(full_bar(st), (j / C::STAGES) & 1);\n"
FAULTS = {
    "none": None,
    "causal boundary one key late": (
        "} else if (causal && kpos > qpos + offset) {",
        "} else if (causal && kpos > qpos + offset + 1) {"),
    "diagonal KV tile skipped": (TILES, TILES.replace("/ kWgBKV;", "/ kWgBKV - 1;")),
    "scores scaled 1% high": (
        "const float scale_log2 = scale * kLog2e;",
        "const float scale_log2 = scale * kLog2e * 1.01f;"),
    "first KV tile skipped for query rows >= 6144": (
        FULL_WAIT,
        FULL_WAIT + "      if (q0 >= 6144 && j == 0) {\n        __syncwarp();\n"
        "        if (lane == 0) mbar_arrive(empty_bar(st));\n        continue;\n      }\n"),
    "ragged last KV tile dropped": (TILES, "const int ntiles = kend / kWgBKV;"),
}
SHAPES = [  # label, b, s, h, kv, d: the serve waves and the long prompt
    ("B=4 S=T=2048", 4, 2048, 32, 4, 128),
    ("B=4 S=T=1000", 4, 1000, 32, 4, 128),
    ("B=1 S=T=8192", 1, 8192, 32, 4, 128),
]


def child(fault: str, src: str, lock: str) -> None:
    sys.path.insert(0, src)
    import repro_torch  # the edited copy, before chip_smoke puts the checkout first
    import torch

    assert pathlib.Path(repro_torch.__file__).is_relative_to(src)
    sys.path.append(str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    _build.build_all(["flash_attention"])
    with open(lock) as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # one fault at a time on the card
        dev = torch.device("cuda", 0)
        rows = []
        for i, (label, b, s, h, kv, d) in enumerate(SHAPES):
            q, k, v = chip_smoke.attn_inputs(b, s, s, h, kv, d, torch.bfloat16, dev, seed=10 + i)
            got = flash_attention_cuda(q, k, v, causal=True).float()
            want = ref.flash_attention(q, k, v, causal=True).float()
            diff = got - want
            rec = dict(fault=fault, shape=label, max_abs_err=diff.abs().max().item(),
                       max_row_err=(diff.norm(dim=-1) / want.norm(dim=-1)).max().item())
            rec["elementwise_ok"] = bool(torch.allclose(got, want, **chip_smoke.FLASH_BF16_TOL))
            try:
                chip_smoke.flash_errors(got, want, torch.bfloat16)
                rec["full_check_ok"] = True
            except AssertionError:
                rec["full_check_ok"] = False
            rows.append(rec)
            del q, k, v, got, want, diff
            torch.cuda.empty_cache()
    print(json.dumps(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--child", nargs=3, metavar=("FAULT", "SRC", "LOCK"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    source = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    text = source.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        lock = pathlib.Path(tmp) / "card.lock"
        lock.touch()
        procs = {}
        for i, (fault, edit) in enumerate(FAULTS.items()):
            src = pathlib.Path(tmp) / f"fault{i}"
            shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            if edit is not None:
                old, new = edit
                if text.count(old) != 1:
                    raise RuntimeError(f"fault {fault!r}: its anchor is not in the source once")
                (src / "repro_torch" / "csrc" / "flash_attention.cu").write_text(
                    text.replace(old, new))
            procs[fault] = subprocess.Popen(
                [sys.executable, __file__, "--child", fault, str(src), str(lock)],
                stdout=subprocess.PIPE, text=True)
        results = {}
        for fault, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"fault {fault!r}: the check exited {proc.returncode}")
            results[fault] = json.loads(out.strip().splitlines()[-1])
    ok = True
    for fault, rows in results.items():
        for r in rows:
            print(json.dumps(r))
        caught = not all(r["full_check_ok"] for r in rows)
        if caught == (fault == "none"):
            ok = False
            print(f"FAIL: {fault!r} {'failed' if caught else 'passed'} the full check")
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the ``repro_torch`` port on one NVIDIA GPU and hold it to its kernels.

    python3 chip_smoke.py

Phases (each failure raises; the script exits non-zero and prints no result):

0. The card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
   No CUDA device -> exit 1.
1. Build every CUDA source of the port with ``nvcc`` (one process per
   source, all started together, and one more for the MI kernel's
   yardsticks in ``tools/mi_score_baseline.cu``: its former design and an
   empty kernel); print the build time and ``-Xptxas -v``, the register and
   spill lines of the five kernels' entries apart, and, where ``cuobjdump``
   sits next to ``nvcc``, count ``SASS_MARKS`` in their libraries:
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile loads) for flash attention,
   ``UBLKCP`` (bulk copies) and ``LDG.E.128`` for the correlation,
   ``LDG.E.128`` and ``LDG.E.64`` for the contingency count, ``LDG.E.128``
   for the bin codes, ``SHFL.BFLY`` (a table reduced across its lanes) for
   MI; a missing mark fails ("not checked" where ``cuobjdump`` is missing).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: contingency counts bitwise equal (int8/int16/int32, the
   class-fused conditional target, a ragged row count, injected negatives and
   sentinels, int32 codes of 16 bins, timed at the binned fits' V*C = 32
   and 256); every path ``contingency_plan`` and ``bin_codes_plan`` pick,
   forced where the main path does not reach it (the scalar width, shared
   tables, global atomics; 4, 2 or 1 features per lane, E > 64), bitwise
   against the plain versions (five dtypes x both layouts x 4/8/32/256 cells,
   unaligned views, 300,000 equal rows); MI within ``rtol=1e-5, atol=1e-6``
   at ``MI_SHAPES`` in int32 and float32 (the main path's tables, an odd
   shape, V=300 and V=13,000) and through the strided class-major view of
   conditional stacks, all-zero tables exactly 0, equal tables bit-equal;
   bin codes bitwise equal
   to the plain version and to the host binner (``QuantileBinner.transform``)
   at 65,536 x 1000 and a ragged 65,499 rows, E of 15 and 63, values planted
   on edges, and NaN (code E), +-inf and -0.0 on every bin-code path; row
   correlations within ``rtol=2e-4, atol=2e-5`` at 50,000 x
   10,000 rows against T=1 and T=4, with a constant row and through the
   ``X.T`` view.  Times with CUDA events (and, for the contingency and
   bin-code kernels, the kernel's own device time from ``torch.profiler``,
   without the wrapper's memset and launch): kernel, plain version, the
   byte/operation bound and a library yardstick (contingency:
   ``torch.bincount`` on the fused index, also for the class-fused
   conditional count; bin codes: one ``torch.searchsorted`` on the
   feature-major transpose, and beside it one device copy of the same
   bytes, what reading and writing them takes on the card; correlation: ``torch.matmul`` of pre-standardised
   rows, the product only).
3. Tall (the paper's Fig. 5/6 point): CorrAL 1,000,000 x 1000 int8, L=10,
   ``mid``.  The in-memory fit (plans ``conventional``), the streaming fit
   over ``ArraySource`` at ``block_obs=65536`` and the in-memory fit with the
   plain versions (``use_kernel=False``) must select the same features, the
   first nine being {0..8}; the streaming ledger must read 10 passes and 160
   blocks.  One more (warm) in-memory fit under ``torch.profiler``: device
   time by kernel and the device's busy share (also in phase 4).
4. Wide (the repo's scaled Fig. 7 point): CorrAL 10,000 x 50,000, L=10,
   plans ``alternative``; kernels and plain versions select the same.
5. Tall continuous (the Fig. 5/6 point with continuous values):
   ``continuous_dataset_np(1_000_000, 1000)`` float32, ``bins=16``, L=10,
   ``mid``.  The fingerprint and the sketch pass run once, timed apart
   (``fit_binned``; every fit below reuses the memoised binner), and so does
   the host binner's ``transform`` of one 65,536-row block, the work the
   device encode replaces.  (a) the
   streaming fused fit at ``block_obs=65536``, (b) the in-memory binned fit
   (host sketch, device encode), (c) (b) with the plain versions must select
   the same, first pick in {0, 8}; (a)'s ledger reads 10 passes, 160 blocks
   and the float blocks' bytes.
6. Wide continuous (the scaled Fig. 7 point, continuous):
   ``continuous_dataset_np(10_000, 50_000)``, L=8, plans ``alternative`` with
   ``PearsonMIScore``; kernel and plain versions select the same, first pick
   in {0, 8}.  Two more (warm) kernel fits: one on the host clock, one under
   ``torch.profiler``, whose device-only activities (kernels, copies) are
   printed by name with their share of the traced fit's wall time.
7. Yi-6B serve (the LM side, at the published widths and depth): random
   bf16 weights from a seeded generator on the card (~6.06e9 parameters),
   ``ServeEngine.serve`` of 8 greedy requests, 32 new tokens each, in two
   waves (4 prompts of 1000 tokens, 4 of 2048), prefill attention through
   the flash-attention kernel (32 launches per wave, one per layer).  Each
   of the 64 prefill attentions of a kernel run is held to the plain version
   on that layer's own q, k and v, within phase 2's bf16 tolerances (the
   per-row one included).  Held against the plain attention
   (``use_kernel=False``) on the same weights and prompts:
   last-position prefill logits within the bf16 model's own
   rounding error (the plain bf16 logits against float32 logits of the same
   weights), greedy tokens equal up to the first step whose plain top-1 /
   top-2 margin is below twice the logits error; then the 2048-token wave in
   float32 (24 GB of weights), whose kernel and plain tokens must be equal.

8. Out of core (the I/O knobs, the file sources and the service), every
   temporary file and spill directory under one directory removed at the
   end: (a) the tall fit of phase 3 as ``MRMRSelector(10, score=MIScore(2,
   2), block_obs=65536, spill_dir=..., readahead=4).fit(ArraySource(X, y))``:
   the same selection as phase 3's streaming fit, 10 passes and 160 blocks,
   one parse and nine replay passes, 160 contingency launches (all int8,
   V=2, C=2) and MI launches; the same fit again parses nothing (ten
   replays), and once more under ``torch.profiler`` (the device's busy
   share).  (b) phase 5's continuous data with ``bins=16`` and
   ``spill_dir``: the staging pass encodes on the host and spills int8
   codes, the replays count them: the same selection as phase 5's streaming
   fit, 0 bin-code launches, 160 contingency launches on int8 codes (V=16,
   C=2 and 16), the spilled bytes; one replayed 65,536 x 1000 code block
   read back as a replay (a memmap, one replay pass and no parse), counted
   bitwise against the plain version and timed at C=2 and 16.  (c) the
   tall data written as CSV with numpy byte operations (all 1,000,000
   rows, about 2 GB of text) and fitted through ``CSVSource(dtype=int8,
   target_dtype=int8)`` with ``spill_dir`` and ``readahead=4``: the
   selection of (a), one parse pass and nine replays, each pass's seconds.
   (d) ``SelectionService(workers=2, device="cuda")`` over
   ``corral:1000000x1000`` with ``spill_dir``: two identical requests at
   once run the engine once (one coalesces; (10 + 5) x 16 contingency
   launches with the distinct request), a distinct request (L=5) runs in
   the other worker meanwhile, a third identical request is a cache hit
   that launches nothing; the results equal direct streamed fits of a fresh
   source with no spill cache.  (e) ``mrmr_custom_score(MIScore(2, 2))`` on
   CorrAL 10,000 x 5,000, the alternative encoding, ``get_result`` vmapped
   over candidate chunks: one contingency and one MI launch a chunk for the
   relevance and as many for the redundancy, every pick; the selection of
   ``MIScore`` and of the same score in plain torch, one pick's scores
   against the plain version's, a NaN relevance.
   Each fit logs its seconds and each streamed pass's seconds.
9. Multi-process map-reduce (``python -m repro_torch.launch.select_multihost
   --device cuda`` in spawn mode: N worker processes started with
   ``subprocess``, each with its own CUDA context on the one card, gloo
   collectives on the host; ``MRMRSelector(hosts="auto")`` in each).  The
   data is written with ``np.save`` under phase 8's temporary directory and
   each worker memmaps it and reads only its shard: (a) phase 3's tall
   arrays, 2 workers, grid (2, 1), L=10 ``mid``, held to phase 3's streaming
   fit; (b) CorrAL 10,000 x 50,000, 2 workers, grid (1, 2), L=10, q=2,
   ``--spill-dir`` (one spill entry each for ``h0`` and ``h1``); (c) CorrAL
   40,000 x 40,000, 4 workers, grid (2, 2) by the automatic rule, L=5
   ``jmi``.  (b) and (c) are held to a one-process streaming fit of the
   same arrays on the card.  Each run: the same selection and bitwise the
   same gains and passes, every worker on the card with the contingency and
   MI launches reckoned from the engine (``expected_worker_launches``) and
   within 1/N +- 5% of the aggregate bytes; the wall seconds, the slowest
   worker's fit and each worker's ``io["hosts"]`` row are printed.  A run of
   N processes on one card is N contexts time-sliced on one device, not
   cluster scaling: no gain is claimed from it.  Then kernel 2 (the
   class-fused count) at (c)'s redundancy block, with and without its
   appended target column.
10. The in-process device mesh (``MRMRSelector(mesh=...)``, meshes of 2 or
   4 positions, every one ``cuda:0``: the shards run one after another on
   one stream).  (a) phase 3's tall arrays on (4,) ``data``, L=10; (b) phase
   4's wide arrays on (4,) ``model``; (c) phase 9's 40,000 x 40,000 arrays,
   ``jmi`` L=5, on a (2, 2) grid (16 class-fused counts); (d) phase 3's
   arrays streamed at 65,536 rows on (2,) ``data``; (e) phase 4's arrays
   streamed at 10,000 rows on (2,) ``model``, the state feature-sharded;
   (f) phase 6's continuous arrays, Pearson, on (2,) ``model``, L=8; (g)
   phase 5's continuous arrays, ``bins=16``, streamed at 65,536 rows on (3,)
   ``model``, L=4 (the fitted edges cut into three feature shards, 1000
   columns padded to 1002 with +inf edge rows; each tile encoded on its
   position once a block; held to the first 4 picks and gains of phase 5's
   streamed fit).  Each is held to the one-device card fit of the same
   data: the same picks,
   bitwise the same MI gains (Pearson within ``CORR_RTOL``/``CORR_ATOL``),
   the launches reckoned from the engine (``expected_mesh_launches``); (a)
   is traced warm (device busy share).  Then the per-shard kernel shapes:
   the count at 250,000 x 1000 (a (4,) data shard), 32,768 x 1000 (half a
   streamed block), the 10,000 x 12,500 column windows of (b) at columns 0
   and 12,500 (each also with the L2 flushed before every call), kernel 2
   at a 20,000 x 20,000 grid tile of (c), and the bin-code kernel at (g)'s
   last tile, 65,536 x 334 with two +inf edge rows, held bitwise to its
   plain version.

After phase 10 the MI kernel is timed at the table shapes of the main
paths and of ``jmi``/``cmim`` (1000 x 2 x 2, 50,000 x 2 x 2, 1000 x 16 x 2,
1000 x 16 x 16, the class-major view of a 1000 x 2 x 2 x 2 stack, phase 9's
20,001 x 2 x 2 and the class-major view of its 20,001 x 2 x 2 x 2 stack,
phase 10's 12,500 x 2 x 2, 20,000 x 2 x 2 and class-major 20,000 x 2 x 2 x 2,
the custom path's 279 x 1 and 279 x 5 stacks of 2 x 2 tables): CUDA
events and its own device time, the former design's on the same inputs, an
empty kernel launched through the same ctypes path (the launch floor), the
plain version, the bound (bytes, or ~10 instructions a cell and a logarithm a
nonzero cell at the SFU rate) and the shape's launches on the main paths.

Phase 2 also holds the flash-attention kernel to its plain version at the
serve shapes (B=4, S=T=2048 and the ragged 1000, H=32, KV=4, D=128, bf16),
a long prompt (B=1, S=T=8192), MHA, S=1, a ragged S, S < T causal and
non-causal: float32 within ``rtol=2e-5, atol=2e-5``, bf16 within
``rtol=3e-2, atol=3e-2`` and, for every dtype, each output row
(``(b, s, h)``, L2 over D) within a relative error of ``1e-2``; it times
the kernel, the plain version and one ``scaled_dot_product_attention(
is_causal=True, enable_gqa=True)`` call (the library yardstick, which the
port never calls).  The flash and correlation timings also print their
share of the bound (bound ms over kernel ms).

Each main-path fit runs with the kernels' launch counts set to 0 just before
it and read just after: an in-memory fit of L=10 counts 10 contingency
launches (1 relevance + 9 folds; no fold follows the last pick), the
streaming fit 160 (10 passes x 16 blocks), and every fit launches the MI
kernel; the streaming binned fit encodes each of its 160 blocks once, the
in-memory binned fit encodes X once, and the wide Pearson fit launches the
correlation kernel 8 times (1 relevance + 7 folds); the Yi-6B serve
launches the flash-attention kernel 64 times (2 waves x 32 layers); each
spilled fit of phase 8 counts 160 blocks and launches no bin-code kernel,
the service run counts its blocks once per engine run, and the custom-score
fit launches each of the contingency and MI kernels twice a chunk a pick;
each phase-9 worker zeroes its counts just before its fit and reads them
just after, and a run's launches are the sum over its workers; each
phase-10 mesh fit counts one contingency launch a shard (a tile) a pass or
block and one MI launch a feature group a pass (two on a conditional pass),
and (g) one bin-code launch a tile a block.  The
second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, the SMs'
# 32-bit non-tensor rate for the integer compare-and-count and float work,
# and the dense bf16 tensor-core rate (attention's products in bf16).
# The float32 rate counts a fused multiply-add as two operations; work that
# is one instruction per operation (a compare, an add) issues at half of it.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SCALAR_INSTR_PER_S = SCALAR_OPS_PER_S / 2
# Special-function results (a logarithm is priced as one): 16 per SM and
# clock, 132 SMs at the 1.98 GHz the float32 peak above assumes.
SFU_PER_S = 132 * 16 * 1.98e9
BF16_OPS_PER_S = 989e12
RTOL, ATOL = 1e-5, 1e-6
# Row correlations: float32 sums over M in another order (tests/test_kernels.py:83).
CORR_RTOL, CORR_ATOL = 2e-4, 2e-5


def log(*parts):
    print(*parts, flush=True)


def kernel_wrappers() -> dict:
    """name -> the wrapper whose ``launches`` counter each path reads."""
    from repro_torch.kernels.binning import bin_codes_cuda
    from repro_torch.kernels.contingency import contingency_tables_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mi_score import mi_scores_cuda
    from repro_torch.kernels.pearson import pearson_corr_cuda

    return dict(contingency_tables=contingency_tables_cuda, mi_scores=mi_scores_cuda,
                bin_codes=bin_codes_cuda, pearson_corr=pearson_corr_cuda,
                flash_attention=flash_attention_cuda)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, name_part: str, reps: int = 5, flush: bool = False) -> float | None:
    """The kernel's own device time per launch (ms) under ``torch.profiler``:
    the self device time of activities whose name contains ``name_part``
    over ``reps`` calls, divided by the launches the trace recorded (it can
    miss one).  Unlike ``cuda_ms`` it leaves out the wrapper's memset, casts
    and launch gaps.  ``flush`` writes 256 MiB (five times the L2) before
    each call, so no call reads what the one before left in the L2.  None if
    the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can come back empty; try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    scratch.zero_()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if name_part in e.key and e.self_device_time_total > 0]
        launches = sum(e.count for e in rows)
        if launches:
            return sum(e.self_device_time_total for e in rows) / 1e3 / launches
    return None


def bound(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over HBM rate vs
    operations over their peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bincount_tables(X, y, v, c):
    """Library yardstick: one ``torch.bincount`` over the fused index."""
    f = X.shape[1]
    idx = (torch.arange(f, device=X.device) * v + X.long()) * c + y.long()[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=f * v * c)
    return counts.reshape(f, v, c).to(torch.int32)


def phase0() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; "
        f"{torch.cuda.device_count()} device(s)")
    return smi


# SASS instructions that show each redesigned kernel is built as designed:
# flash attention's wgmma (HGMMA) fed by TMA tile loads (UTMALDG); the
# correlation kernel's bulk row copies (UBLKCP) and 128-bit global loads; the
# contingency kernels' 128- and 64-bit loads (16-byte words, and 8-byte words
# on 1000-byte rows); the bin-code kernels' 128-bit loads; the MI kernel's
# butterfly shuffles (a table reduced across its lanes).
SASS_MARKS = {"flash_attention": ("HGMMA", "UTMALDG"), "pearson": ("UBLKCP", "LDG.E.128"),
              "contingency": ("LDG.E.128", "LDG.E.64"), "bin_codes": ("LDG.E.128",),
              "mi_score": ("SHFL.BFLY",)}


def sass_check(libs) -> dict:
    """Count SASS_MARKS in each library with ``cuobjdump`` (next to ``nvcc``);
    fails if any mark is missing."""
    from repro_torch.kernels import _build

    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log("[sass] cuobjdump not found next to nvcc: not checked")
        return {}
    counts = {}
    for name, marks in SASS_MARKS.items():
        sass = subprocess.run([str(tool), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = {m: len(re.findall(rf"\b{re.escape(m)}", sass)) for m in marks}
        log(f"[sass] {name}: {json.dumps(counts[name])}")
    missing = {n: [m for m, k in c.items() if k == 0] for n, c in counts.items()}
    if any(missing.values()):
        raise AssertionError(f"SASS lacks the designed instructions: {missing}")
    return counts


BASELINE_SRC = ROOT / "tools" / "mi_score_baseline.cu"


class Baseline:
    """The yardsticks of ``tools/mi_score_baseline.cu``: the MI kernel's
    former design (one thread per table), called as its wrapper called it,
    and an empty kernel launched through the same ctypes path."""

    def __init__(self, path):
        import ctypes

        self.lib = ctypes.CDLL(str(path))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.lib.mi_scores_baseline_launch.argtypes = [P, I, I64, I, I, P, P]
        self.lib.empty_launch.argtypes = [P, P]
        for fn in (self.lib.mi_scores_baseline_launch, self.lib.empty_launch):
            fn.restype = ctypes.c_int

    def mi(self, counts):
        """The former wrapper: (..., V, C) int32 or float32 counts flattened
        to a contiguous (F, V, C) stack (a copy for a strided view), then
        one launch."""
        from repro_torch.kernels import _build

        *lead, v, c = counts.shape
        flat = counts.reshape(-1, v, c).contiguous()
        out = torch.empty((flat.shape[0],), dtype=torch.float32, device=counts.device)
        err = self.lib.mi_scores_baseline_launch(
            flat.data_ptr(), 0 if flat.dtype == torch.int32 else 1, flat.shape[0], v, c,
            out.data_ptr(), torch.cuda.current_stream(counts.device).cuda_stream)
        _build.check(err, "mi_scores_baseline_launch")
        return out.view(lead)

    def empty(self, n, dev):
        """What a wrapper costs with no work: one allocation, one launch."""
        from repro_torch.kernels import _build

        out = torch.empty((n,), dtype=torch.float32, device=dev)
        err = self.lib.empty_launch(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "empty_launch")
        return out


def phase1():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    # The yardsticks build beside the port's sources, one more nvcc at once.
    base_lib = _build.BUILD / "tools" / "libmi_score_baseline.so"
    base_lib.parent.mkdir(parents=True, exist_ok=True)
    base = subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-o", str(base_lib), str(BASELINE_SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        libs = _build.build_all()
        base_out, _ = base.communicate()
    finally:
        if base.poll() is None:
            base.kill()
            base.wait()
    if base.returncode != 0:
        raise RuntimeError(f"nvcc failed for {BASELINE_SRC.name}:\n{base_out}")
    log(f"[build] {len(libs)} libraries and the MI yardsticks in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, out in _build.build_log.items():
        log(f"[build] {name}:\n{out}")
    for name in SASS_MARKS:  # -Xptxas -v of the redesigned kernels, entry by entry
        for line in _build.build_log.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
    return sass_check(libs), Baseline(base_lib)


def phase2(dev):
    from repro_torch.core.contingency import OOR
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    rng = np.random.default_rng(0)
    M, F = 65536, 1000
    count_err = 0
    cases = [
        ("int8 V=2 C=2", torch.int8, M, 2, 2, False),
        ("int8 V=2 VC=4 (conditional)", torch.int8, M, 2, 4, False),
        ("int16 V=2 C=2", torch.int16, M, 2, 2, False),
        ("int32 V=2 C=2", torch.int32, M, 2, 2, False),
        ("int8 ragged M=65499, negatives", torch.int8, 65499, 2, 2, True),
        ("int32 negatives + 2**31-1 sentinels", torch.int32, M, 2, 2, True),
        ("int32 V=16 C=2 (binned codes)", torch.int32, M, 16, 2, False),
    ]
    for label, dtype, m, v, c, dirty in cases:
        X = rng.integers(0, v, (m, F))
        y = rng.integers(0, c, m)
        if dirty:
            X[rng.random((m, F)) < 0.03] = -1
            y[rng.random(m) < 0.03] = -5 if dtype == torch.int8 else OOR
            if dtype == torch.int32:
                X[rng.random((m, F)) < 0.03] = OOR
        Xd = torch.as_tensor(X).to(dtype).to(dev)
        yd = torch.as_tensor(y).to(torch.int32).to(dev)
        got = contingency_tables_cuda(Xd, yd, v, c)
        want = ref.contingency_tables(Xd, yd, v, c)
        diff = (got.long() - want.long()).abs().max().item()
        count_err = max(count_err, diff)
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"contingency {label}: counts differ (max {diff})")
        log(f"[contingency] {label}: {m}x{F} bitwise equal")

    return count_err, phase2_mi(dev, rng)


# MI at the main path's table shapes (tall and wide passes, the binned fits'
# relevance and redundancy), the conditional stack's class slices, an odd
# shape, and tables whose marginals outgrow shared memory (global scratch).
MI_SHAPES = [(1000, 2, 2), (1000, 2, 4), (50000, 2, 2), (1000, 16, 2), (1000, 16, 16),
             (300, 5, 7), (8, 300, 40), (3, 13000, 2)]


def phase2_mi(dev, rng):
    """MI within RTOL/ATOL of the plain version at MI_SHAPES and through the
    strided class-major view of a conditional stack; all-zero tables give 0
    and equal tables bit-equal MI."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mi_score import mi_scores_cuda

    def check(counts, label):
        got, want = mi_scores_cuda(counts), ref.mi_scores(counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        e = (got - want).abs().max().item()
        log(f"[mi] {label}: within rtol={RTOL} atol={ATOL}, max abs err {e:.3e}")
        return got, e

    err = 0.0
    for shape in MI_SHAPES:
        counts = torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)
        counts[::11] = 0  # all-zero tables
        counts[1::11] = counts[2]  # equal tables, wherever they sit
        for dtype in (torch.int32, torch.float32):
            got, e = check(counts.to(dtype), f"{shape} {str(dtype)[6:]}")
            err = max(err, e)
            if not torch.all(got[::11] == 0):
                raise AssertionError(f"MI of an all-zero table is not 0 at {shape}")
            if not torch.all(got[1::11] == got[2]):
                raise AssertionError(f"equal tables give unequal MI at {shape}")
    for shape in [(1000, 2, 2, 2), (300, 16, 16, 2)]:  # (F, V, W, C) conditional stacks
        stack = torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)
        view = stack.movedim(-1, -3)  # what cmi_from_counts hands the kernel
        got, e = check(view, f"class-major view of a {shape} stack")
        err = max(err, e)
        if not torch.equal(got, mi_scores_cuda(view.contiguous())):
            raise AssertionError(f"the strided view and its copy differ at {shape}")
    return err


def time_contingency(X, y, v, c, label, reps=10, flush=False):
    """Events, the kernel's own device time (and, with ``flush``, that time
    with the L2 flushed before each call), the plain version, the bound and
    ``bincount`` at one shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    m, f = X.shape
    ms = cuda_ms(lambda: contingency_tables_cuda(X, y, v, c), reps)
    plain_ms = cuda_ms(lambda: ref.contingency_tables(X, y, v, c), max(2, reps // 5), 1)
    if not torch.equal(bincount_tables(X, y, v, c),
                       contingency_tables_cuda(X, y, v, c)):
        raise AssertionError(f"bincount yardstick disagrees at {label}")
    library_ms = cuda_ms(lambda: bincount_tables(X, y, v, c), max(2, reps // 5), 1)
    device_ms = kernel_device_ms(lambda: contingency_tables_cuda(X, y, v, c), "contingency")
    nbytes = X.numel() * X.element_size() + y.numel() * y.element_size() + f * v * c * 4
    b_ms, b_by = bound(nbytes, m * f)
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               library_ms=library_ms, bytes=nbytes)
    if flush:
        rec["kernel_device_ms_l2_flushed"] = kernel_device_ms(
            lambda: contingency_tables_cuda(X, y, v, c), "contingency", flush=True)
    log(f"[time] contingency {label}: {json.dumps(rec)}")
    return rec


def contingency_paths(dev) -> list:
    """Every path ``contingency_plan`` picks, forced where the main path does
    not reach it (the scalar width, shared tables, global atomics), held
    bitwise to the plain version: five dtypes x both layouts x 4, 8, 32 and
    256 cells, out-of-range values and targets, a ragged row count, unaligned
    and strided views, and a counter that would wrap if flushed late."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.contingency import (
        GLOBAL, SHARED, _forced_plan, contingency_tables_cuda)

    sms = _build.sm_count(dev)
    rng = np.random.default_rng(7)
    seen = set()

    def check(X, y, v, c, label, want=None, **force):
        plan = _forced_plan(X, v, c, sms, **force)
        got = contingency_tables_cuda(X, y, v, c, plan=plan)
        if want is None:
            want = ref.contingency_tables(X, y, v, c)
        if not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item()
            raise AssertionError(f"contingency {label} {force} {plan}: counts differ (max {diff})")
        seen.add((plan.path, plan.lanes_on_rows, plan.vec > 1))

    m, f = 70000, 1000  # ragged against every row range; 1000-byte int8 rows
    for dtype in (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64):
        for v, c in ((2, 2), (2, 4), (16, 2), (16, 16)):
            Xd = torch.as_tensor(rng.integers(-1, v + 1, (m, f))).to(dtype).to(dev)
            yd = torch.as_tensor(rng.integers(-1, c + 1, m)).to(torch.int32).to(dev)
            if dtype == torch.int32:
                Xd[::13, ::7] = 2**31 - 1
                yd[::17] = 2**31 - 1
            want = ref.contingency_tables(Xd, yd, v, c)
            for layout, X in (("row-major", Xd), ("feature-major", Xd.T.contiguous().T)):
                label = f"{str(dtype)[6:]} {layout} V={v} C={c}"
                for force in ({}, {"vec": 1}, {"path": SHARED}, {"path": GLOBAL}):
                    check(X, yd, v, c, label, want, **force)
            del Xd
        log(f"[contingency] {str(dtype)[6:]}: every plan path x both layouts x 4/8/32/256 "
            f"cells bitwise equal")
    X8 = torch.as_tensor(rng.integers(-1, 3, (4099, 1024))).to(torch.int8).to(dev)
    y8 = torch.as_tensor(rng.integers(-1, 3, 4099)).to(torch.int32).to(dev)
    check(X8, y8, 2, 2, "int8 1024-byte rows")  # 16-byte loads on row-major int8
    check(X8[1:, 8:], y8[1:], 2, 2, "int8 rows 8 bytes in")
    check(X8[:, 3:], y8, 2, 2, "int8 unaligned base")
    check(X8[:, 3:200:2], y8, 2, 2, "int8 strided features")
    check(X8[:, 5:6], y8, 2, 2, "int8 one column")
    check(X8.T.contiguous()[:, 1:].T, y8[1:], 2, 2, "int8 feature-major, rows 1 byte in")
    # A byte-lane counter not flushed in time wraps: 300,000 rows of one
    # (value, class) in every feature.
    Xo = torch.zeros((300_000, 64), dtype=torch.int8, device=dev)
    yo = torch.zeros(300_000, dtype=torch.int32, device=dev)
    for layout, X in (("row-major", Xo), ("feature-major", Xo.T.contiguous().T)):
        for force in ({}, {"vec": 1}):
            check(X, yo, 2, 2, f"300000 equal rows {layout}", **force)
    want = {(0, False, True), (1, False, True), (1, False, False),
            (1, True, True), (1, True, False), (2, False, False), (2, True, False)}
    if not want <= seen:
        raise AssertionError(f"paths never reached: {sorted(want - seen)}")
    log(f"[contingency] plan paths reached (path, lanes_on_rows, vector): {sorted(seen)}")
    return sorted(seen)


def bin_codes_paths(dev) -> list:
    """Every path ``bin_codes_plan`` picks (4 or 1 features per lane, the
    E > 64 kernel), forced where the main path does not reach it, bitwise
    against the plain version: E in {1, 15, 31, 63, 70}, a row slice with a
    stride, and an unaligned base."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.binning import _scalar_plan, bin_codes_cuda, bin_codes_plan

    sms = _build.sm_count(dev)
    rng = np.random.default_rng(8)
    seen = set()
    for e in (1, 15, 31, 63, 70):
        X, edges = planted_block(rng, 20011, 1000, e)
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        for label, V in (("", Xd), ("rows 3::2", Xd[3:15000:2]), ("base +4 bytes", Xd[:, 1:])):
            ev = ed[1:] if V.shape[1] == 999 else ed
            for plan in (bin_codes_plan(V, e, sms), _scalar_plan(V, e, sms)):
                got = bin_codes_cuda(V, ev, plan=plan)
                if not torch.equal(got, ref.bin_codes(V, ev)):
                    raise AssertionError(f"bin_codes E={e} {label} {plan}: codes differ")
                seen.add(plan.fpl)
    if seen != {0, 1, 4}:
        raise AssertionError(f"bin_codes paths reached: {sorted(seen)}")
    log(f"[bin_codes] every plan path (features per lane {sorted(seen)}) bitwise equal")
    # NaN takes the top code E as searchsorted sorts it; +-inf, -0.0 against
    # a 0.0 edge: the 4- and 1-feature register paths and the cache kernel.
    for e, fpl in ((15, 4), (63, 1), (70, 0)):
        X, edges = planted_block(rng, 4099, 1000, e)
        edges[:, e // 2] = 0.0
        edges.sort(axis=1)
        X[5::9, 3::7], X[6::9, 2::5], X[7::9, 4::6], X[8::9, 1::3] = np.nan, np.inf, -np.inf, -0.0
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        plan = bin_codes_plan(Xd, e, sms)
        if plan.fpl != fpl:
            raise AssertionError(f"bin_codes E={e}: plan {plan}, want {fpl} features a lane")
        got = bin_codes_cuda(Xd, ed, plan=plan)
        if not (torch.equal(got, ref.bin_codes(Xd, ed))
                and torch.equal(got.cpu(), ref.bin_codes(Xd.cpu(), ed.cpu()))):
            raise AssertionError(f"bin_codes E={e}: NaN / inf / -0.0 codes differ")
        if not torch.all(got[torch.isnan(Xd)] == e):
            raise AssertionError(f"bin_codes E={e}: NaN does not take code {e}")
    log("[bin_codes] NaN (code E), +-inf and -0.0 bitwise equal at E = 15, 63, 70")
    return sorted(seen)


# Contingency counts on int32 bin codes (bins=16): the binned fits' shapes.
# The streaming fit counts each 65,536-row block against the class (C=2,
# relevance) and against a selected feature's codes (C=16, redundancy); the
# in-memory fit counts the whole 1M x 1000 code matrix.
CODE_SHAPES = [
    ("65536x1000 int32 codes V=16 C=2 (binned streaming relevance)", 65536, 2, 40),
    ("65536x1000 int32 codes V=16 C=16 (binned streaming redundancy)", 65536, 16, 40),
    ("1000000x1000 int32 codes V=16 C=16 (binned in-memory redundancy)", 1_000_000, 16, 10),
]


def phase2_codes(dev):
    """Contingency counts on int32 codes: bitwise against the plain version
    and timed at CODE_SHAPES."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    gen = torch.Generator(device=dev).manual_seed(5)
    timings = []
    for label, m, c, reps in CODE_SHAPES:
        X = torch.randint(0, 16, (m, 1000), generator=gen, device=dev, dtype=torch.int32)
        y = torch.randint(0, c, (m,), generator=gen, device=dev, dtype=torch.int32)
        if not torch.equal(contingency_tables_cuda(X, y, 16, c), ref.contingency_tables(X, y, 16, c)):
            raise AssertionError(f"contingency {label}: counts differ")
        log(f"[contingency] {label}: bitwise equal")
        timings.append(time_contingency(X, y, 16, c, label, reps))
        del X, y
        torch.cuda.empty_cache()
    return timings


def time_mi(counts, label, base, mi_tally, reps=200):
    """The MI kernel at one shape: CUDA-event and own device time, the former
    design's (``base``) on the same inputs, an empty launch (the floor), the
    plain version, the bound, and the launches of this shape on the main
    paths (``mi_tally``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mi_score import mi_scores_cuda

    *lead, v, c = counts.shape
    tables = int(np.prod(lead))
    got, want = mi_scores_cuda(counts), ref.mi_scores(counts)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(base.mi(counts), want, rtol=RTOL, atol=ATOL)
    err = (got - want).abs().max().item()
    # In turns (new, old, old, new): host work sets these times at small
    # shapes, and the host's pace drifts within a run.
    new_fn, old_fn = (lambda: mi_scores_cuda(counts)), (lambda: base.mi(counts))
    turns = [cuda_ms(fn, reps, 10) for fn in (new_fn, old_fn, old_fn, new_fn)]
    ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    device_ms = kernel_device_ms(new_fn, "mi_tables_")
    old_device_ms = kernel_device_ms(old_fn, "mi_rows_kernel")
    empty_ms = cuda_ms(lambda: base.empty(tables, counts.device), reps, 10)
    empty_device_ms = kernel_device_ms(lambda: base.empty(tables, counts.device), "empty_kernel")
    plain_ms = cuda_ms(lambda: ref.mi_scores(counts), reps // 4)
    nbytes = counts.numel() * counts.element_size() + tables * 4
    # ~10 instructions a cell (convert, three sums, two divisions, product,
    # clamps, multiply); one logarithm a nonzero cell, at the SFU rate.
    logs = int((counts > 0).sum())
    b_ms, b_by = max(bound(nbytes, 10 * counts.numel(), SCALAR_INSTR_PER_S),
                     bound(nbytes, logs, SFU_PER_S))
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, old_ms=old_ms,
               old_kernel_device_ms=old_device_ms, empty_launch_ms=empty_ms,
               empty_kernel_device_ms=empty_device_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, bytes=nbytes, logs=logs, max_abs_err=err,
               main_path_launches=mi_tally.get(tuple(counts.shape), 0))
    log(f"[time] mi {label}: {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def tally_mi_shapes(tally):
    """While open, count the MI kernel's launches by table shape (into
    ``tally``) at the dispatcher; the wrapper's own counter is untouched."""
    from repro_torch.kernels import ops

    inner = ops.mi_scores_cuda

    def counted(counts):
        tally[tuple(counts.shape)] = tally.get(tuple(counts.shape), 0) + 1
        return inner(counts)

    ops.mi_scores_cuda = counted
    try:
        yield
    finally:
        ops.mi_scores_cuda = inner


# Launches of the MI kernel on the main paths, by table shape.
MI_TALLY: dict = {}


def run_path(name, fn, dev, launches):
    """Drive one main-path fit with the launch counts zeroed just before
    and read just after; returns (result, record)."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with tally_mi_shapes(MI_TALLY):
        res = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    launches[name] = counts
    rec = dict(path=name, seconds=seconds, launches=counts,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               selected=res.selected_.tolist(),
               gains=[float(g) for g in res.gains_])
    if res.result_.io is not None:
        rec["io"] = res.result_.io
    log(f"[fit] {json.dumps(rec)}")
    return res, rec


def check_same_selection(a, b, what):
    if not np.array_equal(a.selected_, b.selected_):
        raise AssertionError(
            f"{what}: selections differ: {a.selected_.tolist()} "
            f"(gains {a.gains_.tolist()}) vs {b.selected_.tolist()} "
            f"(gains {b.gains_.tolist()})"
        )
    np.testing.assert_allclose(a.gains_, b.gains_, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def check_finite(sel, n):
    if sel.scores_.shape != (n,) or not np.all(np.isfinite(sel.scores_)):
        raise AssertionError("relevance is not a finite (n,) vector")
    if not np.all(np.isfinite(sel.gains_)):
        raise AssertionError("gains are not finite")


def phase3(dev, launches, timings, keep):
    from repro_torch import ArraySource, MIScore, MRMRSelector
    from repro_torch.data.synthetic import corral_dataset_np

    t0 = time.perf_counter()
    X, y = corral_dataset_np(1_000_000, 1000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    log(f"[tall] data 1000000x1000 int8 made and placed in "
        f"{time.perf_counter() - t0:.3f} s")

    timings.append(time_contingency(Xd, yd, 2, 2, "1000000x1000 int8 (tall fit pass)"))
    timings.append(time_contingency(Xd[:65536], yd[:65536], 2, 2,
                                    "65536x1000 int8 (streaming block)", reps=40))

    kern, rec = run_path("tall_conventional",
                         lambda: MRMRSelector(10).fit(Xd, yd), dev, launches)
    # Where a warm in-memory fit's time goes: the count kernel against the rest.
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10).fit(Xd, yd))
    log(f"[tall] warm in-memory fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "conventional":
        raise AssertionError(f"tall fit planned {kern.plan_.encoding}")
    stream, srec = run_path(
        "tall_streaming",
        lambda: MRMRSelector(10, score=MIScore(2, 2), block_obs=65536).fit(
            ArraySource(X, y)),
        dev, launches)
    plain, prec = run_path(
        "tall_plain",
        lambda: MRMRSelector(10, score=MIScore(2, 2, use_kernel=False)).fit(Xd, yd),
        dev, launches)

    check_same_selection(kern, stream, "tall in-memory vs streaming")
    check_same_selection(kern, plain, "tall kernels vs plain versions")
    check_finite(kern, 1000)
    if set(kern.selected_[:9].tolist()) != set(range(9)):
        raise AssertionError(f"first nine picks {kern.selected_[:9]} != 0..8")
    io = stream.result_.io
    if io["passes"] != 10 or io["blocks_read"] != 160:
        raise AssertionError(f"streaming ledger {io}")
    want = {"tall_conventional": 10, "tall_streaming": 160, "tall_plain": 0}
    for path, n in want.items():
        if launches[path]["contingency_tables"] != n:
            raise AssertionError(f"{path}: {launches[path]} launches, want {n}")
        if (launches[path]["mi_scores"] > 0) != (n > 0):
            raise AssertionError(f"{path}: MI launches {launches[path]}")
    del Xd, yd
    keep["tall"] = (X, y)  # phase 8 streams the same data out of core
    return [rec, srec, prec]


def phase4(dev, launches, timings, keep):
    from repro_torch import MIScore, MRMRSelector
    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(10_000, 50_000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    timings.append(time_contingency(Xd, yd, 2, 2, "10000x50000 int8 (wide fit pass)"))
    Xfm = Xd.T.contiguous()  # feature-major storage, read through its .T view
    timings.append(time_contingency(Xfm.T, yd, 2, 2,
                                    "10000x50000 int8 feature-major"))
    del Xfm

    kern, rec = run_path("wide_alternative",
                         lambda: MRMRSelector(10).fit(Xd, yd), dev, launches)
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10).fit(Xd, yd))
    log(f"[wide] warm in-memory fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "alternative":
        raise AssertionError(f"wide fit planned {kern.plan_.encoding}")
    plain, prec = run_path(
        "wide_plain",
        lambda: MRMRSelector(10, score=MIScore(2, 2, use_kernel=False)).fit(Xd, yd),
        dev, launches)
    check_same_selection(kern, plain, "wide kernels vs plain versions")
    check_finite(kern, 50_000)
    if launches["wide_alternative"]["contingency_tables"] != 10:
        raise AssertionError(f"wide launches {launches['wide_alternative']}")
    if launches["wide_alternative"]["mi_scores"] == 0:
        raise AssertionError("wide fit never launched the MI kernel")
    log(f"[wide] relevant picks among the first nine: "
        f"{len(set(kern.selected_[:9].tolist()) & set(range(9)))}/9")
    keep["wide"] = (X, y)  # phase 10 shards the same data
    return [rec, prec]


def time_conditional(X, xj, y, label, reps=40):
    """The class-fused conditional count (kernel 1 behind ``fuse_targets``)."""
    from repro_torch.core.contingency import fuse_targets
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import conditional_tables_cuda

    from repro_torch.kernels.contingency import contingency_tables_cuda

    m, f = X.shape
    got = conditional_tables_cuda(X, xj, y, 2, 2)
    if not torch.equal(got, ref.conditional_tables(X, xj, y, 2, 2)):
        raise AssertionError(f"conditional counts differ at {label}")
    ms = cuda_ms(lambda: conditional_tables_cuda(X, xj, y, 2, 2), reps)
    fused = fuse_targets(xj, y, 2, 2)
    count_ms = cuda_ms(lambda: contingency_tables_cuda(X, fused, 2, 4), reps)
    plain_ms = cuda_ms(lambda: ref.conditional_tables(X, xj, y, 2, 2), 4, 1)
    library_ms = cuda_ms(lambda: bincount_tables(X, fuse_targets(xj, y, 2, 2), 2, 4), 4, 1)
    nbytes = X.numel() * X.element_size() + 2 * m * 4 + f * 2 * 4 * 4
    b_ms, b_by = bound(nbytes, m * f)
    rec = dict(shape=label, ms=ms, count_only_ms=count_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, bytes=nbytes)
    log(f"[time] conditional {label}: {json.dumps(rec)}")
    return rec


def planted_block(rng, b, n, e):
    """Float32 block and sorted edges (one duplicate), values planted on edges."""
    X = rng.standard_normal((b, n), dtype=np.float32)
    edges = np.sort(rng.standard_normal((n, e), dtype=np.float32), axis=1)
    if e > 1:
        edges[:, 1] = edges[:, 0]
    X[::7] = edges[np.arange(n), rng.integers(0, e, n)]
    X[1], X[2] = -0.0, 0.0
    return X, edges


def phase2_bins(dev):
    """bin_codes bitwise against the plain version and the host binner."""
    from repro_torch import QuantileBinner
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    rng = np.random.default_rng(2)
    err, timings = 0, []
    for label, b, e in [("65536x1000 E=15", 65536, 15), ("ragged 65499x1000 E=15", 65499, 15),
                        ("65536x1000 E=63", 65536, 63)]:
        X, edges = planted_block(rng, b, 1000, e)
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        got = bin_codes_cuda(Xd, ed)
        want = ref.bin_codes(Xd, ed)
        binner = QuantileBinner(e + 1)
        binner.edges_ = edges
        host = torch.from_numpy(binner.transform(X))
        diff = max((got.long() - want.long()).abs().max().item(),
                   (got.cpu().long() - host.long()).abs().max().item())
        err = max(err, diff)
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"bin_codes {label}: codes differ (max {diff})")
        log(f"[bin_codes] {label}: bitwise equal to the plain version and the host binner")
        if b == 65536:
            timings.append(time_bins(Xd, ed, f"{label} (streaming block)", reps=40))
    gen = torch.Generator(device=dev).manual_seed(2)
    Xd = torch.randn((1_000_000, 1000), generator=gen, device=dev)
    ed = torch.sort(torch.randn((1000, 15), generator=gen, device=dev), dim=1).values
    if not torch.equal(bin_codes_cuda(Xd, ed), ref.bin_codes(Xd, ed)):
        raise AssertionError("bin_codes 1000000x1000: codes differ")
    timings.append(time_bins(Xd, ed, "1000000x1000 E=15 (in-memory fit)", reps=10))
    return err, timings


def check_bins(Xd, ed, label, reps):
    """bin_codes held bitwise to its plain version at one shape, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    diff = (bin_codes_cuda(Xd, ed).long() - ref.bin_codes(Xd, ed).long()).abs().max().item()
    if diff != 0:
        raise AssertionError(f"bin_codes {label}: codes differ (max {diff})")
    log(f"[bin_codes] {label}: bitwise equal to the plain version")
    return dict(time_bins(Xd, ed, label, reps), max_abs_err=diff)


def time_bins(Xd, ed, label, reps):
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    b, n = Xd.shape
    e = ed.shape[1]
    ms = cuda_ms(lambda: bin_codes_cuda(Xd, ed), reps)
    plain_ms = cuda_ms(lambda: ref.bin_codes(Xd, ed), max(2, reps // 5), 1)
    Xt = Xd.T.contiguous()  # the library call's own layout, made outside the timing
    library_ms = cuda_ms(lambda: torch.searchsorted(ed, Xt, right=True), max(2, reps // 5), 1)
    del Xt
    device_ms = kernel_device_ms(lambda: bin_codes_cuda(Xd, ed), "bin_codes")
    # What reading and writing the same bytes takes on this card: one copy.
    out = torch.empty((b, n), dtype=torch.int32, device=Xd.device)
    copy_ms = cuda_ms(lambda: out.copy_(Xd.view(torch.int32)), max(2, reps // 5), 1)
    del out
    nbytes = 2 * b * n * 4 + n * e * 4
    # A compare and an add per edge and element, one instruction each.
    b_ms, b_by = bound(nbytes, 2 * b * n * e, SCALAR_INSTR_PER_S)
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               copy_ms=copy_ms, library_ms=library_ms, library="torch.searchsorted(right=True) on the "
               "(N, B) transpose", bytes=nbytes)
    log(f"[time] bin_codes {label}: {json.dumps(rec)}")
    return rec


def phase2_pearson(dev):
    """pearson_corr within CORR_RTOL/CORR_ATOL of the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pearson import pearson_corr_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    F, M = 50_000, 10_000
    X = torch.randn((F, M), generator=gen, device=dev) * 2 + 3
    X[7] = 2.5  # a constant row correlates 0
    err, timings = 0.0, []
    for t in (1, 4):
        Y = torch.randn((t, M), generator=gen, device=dev)
        got = pearson_corr_cuda(X, Y)
        want = ref.pearson_corr(X, Y)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)
        if not torch.all(got[7] == 0):
            raise AssertionError("a constant row does not correlate 0")
        e = (got - want).abs().max().item()
        err = max(err, e)
        log(f"[pearson] {F}x{M} against T={t}: within rtol={CORR_RTOL} "
            f"atol={CORR_ATOL}, max abs err {e:.3e}")
        timings.append(time_pearson(X, Y, f"{F}x{M} T={t}", reps=20 if t == 1 else 5))
    Xv = X[:2000].T.contiguous().T  # the X.T view of a row-major matrix
    Y = torch.randn((1, M), generator=gen, device=dev)
    got = pearson_corr_cuda(Xv, Y)
    torch.testing.assert_close(got, ref.pearson_corr(Xv, Y), rtol=CORR_RTOL, atol=CORR_ATOL)
    err = max(err, (got - ref.pearson_corr(Xv, Y)).abs().max().item())
    log("[pearson] 2000x10000 through the X.T view: within tolerance")
    return err, timings


def time_pearson(X, Y, label, reps):
    from repro_torch.kernels import ref
    from repro_torch.kernels.pearson import pearson_corr_cuda

    f, m = X.shape
    t = Y.shape[0]
    ms = cuda_ms(lambda: pearson_corr_cuda(X, Y), reps)
    plain_ms = cuda_ms(lambda: ref.pearson_corr(X, Y), 3, 1)
    Xs, Ys = ref.standardize_rows(X), ref.standardize_rows(Y)
    library_ms = cuda_ms(lambda: torch.matmul(Xs, Ys.T) / m, reps)
    del Xs, Ys
    nbytes = (f * m + t * m + f * t) * 4
    b_ms, b_by = bound(nbytes, 4 * f * m + 2 * f * m * t)
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, library_ms=library_ms,
               library="torch.matmul of pre-standardised rows (product only)", bytes=nbytes)
    log(f"[time] pearson_corr {label}: {json.dumps(rec)}")
    return rec


def phase5(dev, launches, keep):
    from repro_torch import ArraySource, MIScore, MRMRSelector, fit_binned
    from repro_torch.data.synthetic import continuous_dataset_np

    t0 = time.perf_counter()
    X, y = continuous_dataset_np(1_000_000, 1000, seed=0)
    log(f"[tall-binned] data 1000000x1000 float32 made in {time.perf_counter() - t0:.3f} s")
    src = ArraySource(X, y)
    t0 = time.perf_counter()
    src.fingerprint()
    fp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binner = fit_binned(src, 16, block_obs=65536).binner
    sketch_s = time.perf_counter() - t0
    # What the device encode replaces: the host binner on one streaming block.
    t0 = time.perf_counter()
    binner.transform(X[:65536])
    transform_s = time.perf_counter() - t0
    log(f"[tall-binned] fingerprint (sha256 of 4 GB) {fp_s:.3f} s; "
        f"sketch pass {sketch_s:.3f} s; host QuantileBinner.transform of one "
        f"65536x1000 block {transform_s:.3f} s")

    stream, srec = run_path(
        "tall_binned_streaming",
        lambda: MRMRSelector(10, bins=16, block_obs=65536).fit(src), dev, launches)
    mem, mrec = run_path(
        "tall_binned_in_memory", lambda: MRMRSelector(10, bins=16).fit(X, y), dev, launches)
    plain, prec = run_path(
        "tall_binned_plain",
        lambda: MRMRSelector(10, bins=16, score=MIScore(16, 2, use_kernel=False)).fit(X, y),
        dev, launches)
    check_same_selection(stream, mem, "tall binned streaming vs in-memory")
    check_same_selection(mem, plain, "tall binned kernels vs plain versions")
    check_finite(mem, 1000)
    if (stream.plan_.bins, mem.plan_.bins) != (16, 16):
        raise AssertionError("binned fits did not record bins=16")
    if int(mem.selected_[0]) not in (0, 8):
        raise AssertionError(f"first binned pick {mem.selected_[0]} not in {{0, 8}}")
    io = stream.result_.io
    if (io["passes"], io["blocks_read"], io["bytes_read"]) != (10, 160, 10 * (X.nbytes + y.nbytes)):
        raise AssertionError(f"binned streaming ledger {io}")
    a, b, c = (launches[p] for p in ("tall_binned_streaming", "tall_binned_in_memory",
                                     "tall_binned_plain"))
    if (a["bin_codes"], a["contingency_tables"]) != (160, 160) or a["mi_scores"] == 0:
        raise AssertionError(f"binned streaming launches {a}")
    if b["bin_codes"] < 1 or b["contingency_tables"] != 10 or b["mi_scores"] == 0:
        raise AssertionError(f"binned in-memory launches {b}")
    if any(c.values()):
        raise AssertionError(f"plain-version binned fit launched kernels: {c}")
    keep["binned_src"] = src  # fingerprint and fitted binner memoised
    return [dict(srec, fingerprint_s=fp_s, sketch_s=sketch_s,
                 host_transform_block_s=transform_s), mrec, prec]


def device_breakdown(fn, top=6):
    """Time ``fn()`` once on the host clock, then once more under
    ``torch.profiler``: the device-only activities (kernels, copies) by
    name, their sum, and its share of the profiled call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.self_cpu_time_total == 0 and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in rows)
    return dict(host_s=host_s, profiled_wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                top=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:top]])


def phase6(dev, launches, keep):
    from repro_torch import MRMRSelector, PearsonMIScore
    from repro_torch.data.synthetic import continuous_dataset_np

    t0 = time.perf_counter()
    X, y = continuous_dataset_np(10_000, 50_000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    keep["pearson"] = (X, y)  # phase 10 shards the same data
    log(f"[wide-pearson] data 10000x50000 float32 made and placed in "
        f"{time.perf_counter() - t0:.3f} s")
    kern, rec = run_path("wide_pearson", lambda: MRMRSelector(8).fit(Xd, yd), dev, launches)
    # Where a warm fit's time goes: the correlation kernel against the rest.
    rec["trace"] = device_breakdown(lambda: MRMRSelector(8).fit(Xd, yd))
    log(f"[wide-pearson] warm fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "alternative" or not isinstance(kern.plan_.score, PearsonMIScore):
        raise AssertionError(f"wide continuous fit planned {kern.plan_}")
    plain, prec = run_path(
        "wide_pearson_plain",
        lambda: MRMRSelector(8, score=PearsonMIScore(use_kernel=False)).fit(Xd, yd),
        dev, launches)
    if not np.array_equal(kern.selected_, plain.selected_):
        raise AssertionError(f"wide Pearson selections differ: {kern.selected_} vs "
                             f"{plain.selected_}")
    np.testing.assert_allclose(kern.gains_, plain.gains_, rtol=CORR_RTOL, atol=CORR_ATOL)
    check_finite(kern, 50_000)
    if int(kern.selected_[0]) not in (0, 8):
        raise AssertionError(f"first Pearson pick {kern.selected_[0]} not in {{0, 8}}")
    if launches["wide_pearson"]["pearson_corr"] != 8:
        raise AssertionError(f"wide Pearson launches {launches['wide_pearson']}")
    if any(launches["wide_pearson_plain"].values()):
        raise AssertionError(f"plain Pearson fit launched {launches['wide_pearson_plain']}")
    return [rec, prec]


FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py, float32
FLASH_BF16_TOL = dict(rtol=3e-2, atol=3e-2)  # tests/test_kernels.py, bf16
# Per-row relative error |got - want| / |want| (L2 over D), max over (b, s, h).
# At S = 2048-8192 a row's output shrinks to ~0.02-0.04, inside the bf16 atol
# above, so that elementwise tolerance alone passes a kernel whose scores are
# 1% too large (tools/flash_planted_faults.py); a row's relative error does
# not shrink with the output. bf16 rounds P for P.V and the output once
# each: ~4-5e-3 per row.
FLASH_ROW_RTOL = 1e-2


def flash_errors(got, want, dtype):
    """Hold a flash output to its plain version; (max abs err, max row err)."""
    got, want = got.float(), want.float()
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    diff = got - want
    row = (diff.norm(dim=-1) / want.norm(dim=-1)).max().item()
    if not row <= FLASH_ROW_RTOL:
        raise AssertionError(f"flash attention row error {row:.3e} > {FLASH_ROW_RTOL}")
    return diff.abs().max().item(), row


def attn_inputs(b, s, t, h, kv, d, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def visible_pairs(s, t, causal):
    """(query, key) pairs the attention needs: query i sees keys <= i + t - s."""
    if not causal:
        return s * t
    i = np.arange(s)
    return int(np.clip(i + t - s + 1, 0, t).sum())


def phase2_flash(dev):
    """flash_attention against its plain version, and its times."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # label, b, s, t, h, kv, d, causal, dtype, timed
        ("serve prefill B=4 S=T=2048", 4, 2048, 2048, 32, 4, 128, True, bf, True),
        ("ragged wave B=4 S=T=1000", 4, 1000, 1000, 32, 4, 128, True, bf, True),
        ("long prompt B=1 S=T=8192", 1, 8192, 8192, 32, 4, 128, True, bf, True),
        ("MHA B=2 S=T=512 H=KV=32", 2, 512, 512, 32, 32, 128, True, f32, False),
        ("S=T=1", 4, 1, 1, 32, 4, 128, True, f32, False),
        ("ragged S=T=1000 f32", 2, 1000, 1000, 32, 4, 128, True, f32, False),
        ("S=256 < T=2048 causal", 2, 256, 2048, 32, 4, 128, True, f32, False),
        ("non-causal S=300 T=1000", 2, 300, 1000, 32, 4, 128, False, f32, False),
        ("D=64 S=T=777 bf16", 2, 777, 777, 16, 16, 64, True, bf, False),
    ]
    err, timings = 0.0, []
    for i, (label, b, s, t, h, kv, d, causal, dtype, timed) in enumerate(cases):
        q, k, v = attn_inputs(b, s, t, h, kv, d, dtype, dev, seed=10 + i)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        e, row = flash_errors(got, want, dtype)
        del want
        err = max(err, e)
        log(f"[flash] {label} {str(dtype)[6:]}: max abs err {e:.3e}, "
            f"max row err {row:.3e}")
        if timed:
            timings.append(time_flash(q, k, v, label))
        del q, k, v, got
        torch.cuda.empty_cache()
    return err, timings


def time_flash(q, k, v, label):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    reps = 20 if s * b <= 8192 else 10
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), reps)
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True), 2, 1)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
    torch.testing.assert_close(lib.float(), flash_attention_cuda(q, k, v, causal=True).float(),
                               **FLASH_BF16_TOL)
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), reps)
    es = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * t * kvh * d) * es
    flops = 4 * b * h * d * visible_pairs(s, t, True)
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, library_ms=library_ms,
               library="scaled_dot_product_attention(is_causal=True, "
               "enable_gqa=True)", bytes=nbytes, flops=flops,
               tflops=flops / ms / 1e9)
    log(f"[time] flash_attention {label}: {json.dumps(rec)}")
    return rec


def margin_engine(model, **kw):
    """A ServeEngine that keeps, for each sampled step, the top-1 / top-2
    logit margin of every row (waves in serving order) in ``.margins``."""
    from repro_torch.serve import ServeEngine

    class MarginEngine(ServeEngine):
        def _sample(self, logits):
            top = torch.topk(logits.float(), 2, dim=-1).values
            self.margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
            return super()._sample(logits)

    engine = MarginEngine(model, **kw)
    engine.margins = []
    return engine


def serve_run(name, model, reqs, dev, launches, use_kernel="auto"):
    """Serve ``reqs`` with launch counts zeroed just before and read just
    after; prefill's flash launches are also counted per wave."""
    wrappers = kernel_wrappers()
    flash = wrappers["flash_attention"]
    per_wave = []
    prefill = model.prefill

    def counted_prefill(*a, **kw):
        before = flash.launches
        out = prefill(*a, **kw)
        per_wave.append(flash.launches - before)
        return out

    model.prefill = counted_prefill
    engine = margin_engine(model, use_kernel=use_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        outs = engine.serve(reqs)
    finally:
        del model.prefill
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches[name] = {k: w.launches for k, w in wrappers.items()}
    new = sum(len(o) for o in outs)
    steps = sum(w["decode_steps"] for w in engine.stats)
    rec = dict(path=name, seconds=seconds, launches=launches[name],
               flash_launches_per_wave=per_wave, waves=engine.stats,
               prefill_s=[w["prefill_s"] for w in engine.stats],
               decode_ms_per_step=1e3 * sum(w["decode_s"] for w in engine.stats) / steps,
               new_tokens=new, tokens_per_s=new / seconds,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"[serve] {json.dumps(rec)}")
    return outs, engine.margins, rec


def wave_rows(reqs):
    """Request index -> (wave, row) in the engine's serving order."""
    lens = sorted({len(r.prompt) for r in reqs})
    rows: dict = {}
    for i in sorted(range(len(reqs)), key=lambda i: len(reqs[i].prompt)):
        w = lens.index(len(reqs[i].prompt))
        rows[i] = (w, sum(1 for wr in rows.values() if wr[0] == w))
    return rows


@contextlib.contextmanager
def held_to_plain(errs):
    """While open, every prefill attention is also computed by the plain
    version on the same q, k, v (the layer's own activations) and held to it
    with ``flash_errors``; ``errs`` collects (max abs err, max row err)."""
    from repro_torch.kernels import ops, ref

    inner = ops.flash_attention

    def checked(q, k, v, *, causal, use_kernel="auto"):
        out = inner(q, k, v, causal=causal, use_kernel=use_kernel)
        errs.append(flash_errors(out, ref.flash_attention(q, k, v, causal=causal), q.dtype))
        return out

    ops.flash_attention = checked
    try:
        yield
    finally:
        ops.flash_attention = inner


def last_logits(model, reqs, use_kernel):
    """Last-position prefill logits (float32) of every request, by wave."""
    out = []
    for n in sorted({len(r.prompt) for r in reqs}):
        toks = torch.tensor([r.prompt for r in reqs if len(r.prompt) == n], device=model.device)
        logits, caches = model.prefill(toks, use_kernel=use_kernel)
        out.append(logits.float())
        del caches
    return out


def phase7(dev, launches):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[yi6b] {model.num_params()} parameters, {model.weight_bytes()} weight bytes "
        f"(bf16), made on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    new = 32
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).tolist(), new)
            for n in [2048] * 4 + [1000] * 4]
    rows = wave_rows(reqs)
    n_layers = cfg.num_layers
    # Warm-up (library handles, allocator): one short request, not counted.
    margin_engine(model).serve([Request(reqs[0].prompt[:64], 2)])

    outs, _, rec = serve_run("yi6b_serve", model, reqs, dev, launches)
    if rec["flash_launches_per_wave"] != [n_layers, n_layers]:
        raise AssertionError(f"flash launches per wave {rec['flash_launches_per_wave']}, "
                             f"want {n_layers} per wave")
    plain, margins, prec = serve_run("yi6b_serve_plain", model, reqs, dev, launches,
                                     use_kernel=False)
    if any(launches["yi6b_serve_plain"].values()):
        raise AssertionError(f"plain serve launched {launches['yi6b_serve_plain']}")
    for o in outs:
        if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad generation {o}")

    # The kernel inside the model: each of the 64 prefill attentions of the
    # two waves held to the plain version on its own inputs, so no error of
    # an earlier layer enters the comparison.
    layer_errs = []
    flash = kernel_wrappers()["flash_attention"]
    before = flash.launches
    with held_to_plain(layer_errs):
        kern_logits = last_logits(model, reqs, "auto")
    if flash.launches - before != 2 * n_layers or len(layer_errs) != 2 * n_layers:
        raise AssertionError(f"held {len(layer_errs)} prefill attentions, "
                             f"{flash.launches - before} launches; want {2 * n_layers}")
    layer_abs_err = max(e for e, _ in layer_errs)
    layer_row_err = max(r for _, r in layer_errs)
    log(f"[yi6b] prefill attention in the model, kernel vs plain on each layer's own "
        f"q, k, v: max abs err {layer_abs_err:.4e}, max row err {layer_row_err:.4e} "
        f"(limit {FLASH_ROW_RTOL})")
    plain_logits = last_logits(model, reqs, False)
    logit_err = max((a - b).abs().max().item() for a, b in zip(kern_logits, plain_logits))
    for lg in kern_logits:
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite prefill logits")
    agree = []
    for i, (a, b) in enumerate(zip(outs, plain)):
        w, r = rows[i]
        low = [j for j in range(new) if margins[new * w + j][r] < 2 * logit_err]
        first_low = low[0] if low else new
        first_diff = next((j for j in range(new) if a[j] != b[j]), new)
        if first_diff < first_low:
            raise AssertionError(
                f"request {i}: kernel and plain tokens differ at step {first_diff}, "
                f"before the first low-margin step {first_low}")
        agree.append(dict(request=i, prompt_len=len(reqs[i].prompt), first_diff=first_diff,
                          first_low_margin_step=first_low))
    log(f"[yi6b] bf16 tokens, kernel vs plain: {json.dumps(agree)}")
    del model
    torch.cuda.empty_cache()

    # Float32 at full width and depth: the same weights before bf16 rounding.
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[yi6b] float32 model, {model.weight_bytes()} weight bytes, made in "
        f"{time.perf_counter() - t0:.3f} s")
    f32_logits = last_logits(model, reqs, False)
    bf16_err = max((a - b).abs().max().item() for a, b in zip(plain_logits, f32_logits))
    log(f"[yi6b] last-position logits: kernel vs plain (bf16) max abs err {logit_err:.4e}; "
        f"plain bf16 vs float32 (the bf16 model's own rounding) {bf16_err:.4e}")
    if not logit_err <= bf16_err:
        raise AssertionError(f"kernel-vs-plain logits error {logit_err} exceeds the bf16 "
                             f"model's own rounding error {bf16_err}")
    wave = reqs[:4]  # the 2048-token prompts
    f32_outs, _, frec = serve_run("yi6b_serve_f32", model, wave, dev, launches)
    f32_plain, _, fprec = serve_run("yi6b_serve_f32_plain", model, wave, dev, launches,
                                    use_kernel=False)
    if frec["flash_launches_per_wave"] != [n_layers]:
        raise AssertionError(f"float32 wave flash launches {frec['flash_launches_per_wave']}")
    if f32_outs != f32_plain:
        raise AssertionError(f"float32 tokens differ: {f32_outs} vs {f32_plain}")
    log("[yi6b] float32 wave: kernel and plain tokens equal")
    del model
    torch.cuda.empty_cache()
    recs = [rec, prec, frec, fprec]
    for r in recs:
        r.update(arch="yi-6b")
    return recs, dict(logit_err=logit_err, bf16_vs_f32_err=bf16_err, agreement=agree,
                      layer_abs_err=layer_abs_err, layer_row_err=layer_row_err)


# -- phase 8: the out-of-core surfaces ---------------------------------------

OOC_BLOCK = 65536  # block_obs of every phase-8 fit, as in phases 3 and 5
SERVICE_REF = "corral:1000000x1000"
CUSTOM_SHAPE = (10_000, 5_000)
OOC_PATHS = ("ooc_tall_spill", "ooc_tall_replay", "ooc_binned_spill", "ooc_csv",
             "ooc_service", "ooc_custom")


@contextlib.contextmanager
def pass_clock(passes):
    """While open, append each streamed pass's wall seconds, as the fit
    consumes it (read, place, count, finalize), to ``passes``."""
    from repro_torch.core import streaming

    inner = streaming._score_pass

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        passes.append(time.perf_counter() - t0)
        return out

    streaming._score_pass = timed
    try:
        yield
    finally:
        streaming._score_pass = inner


@contextlib.contextmanager
def tally_count_inputs(tally):
    """While open, count the contingency kernel's launches by (X dtype, V, C)
    at the dispatcher; the wrapper's own counter is untouched."""
    from repro_torch.kernels import ops

    inner = ops.contingency_tables_cuda

    def counted(X, y, v, c):
        key = f"{str(X.dtype).removeprefix('torch.')} V={v} C={c}"
        tally[key] = tally.get(key, 0) + 1
        return inner(X, y, v, c)

    ops.contingency_tables_cuda = counted
    try:
        yield
    finally:
        ops.contingency_tables_cuda = inner


def spill_fit(name, fit, dev, launches):
    """``run_path`` with the per-pass clock and the count-input tally open:
    (result, record) with ``pass_s`` (the first a parse pass when the
    cache staged), ``count_inputs`` and the spill counters."""
    passes, inputs = [], {}
    with pass_clock(passes), tally_count_inputs(inputs):
        res, rec = run_path(name, fit, dev, launches)
    rec.update(pass_s=passes, count_inputs=inputs)
    log(f"[ooc] {name}: passes {json.dumps(passes)}; contingency launches by input "
        f"{json.dumps(inputs)}")
    return res, rec


def check_io(res, what, passes, blocks, parse, replay):
    io = res.result_.io
    cache = io.get("cache", {})
    got = (io["passes"], io["blocks_read"], cache.get("parse_passes"), cache.get("replay_passes"))
    if got != (passes, blocks, parse, replay):
        raise AssertionError(f"{what}: io {io}, want passes/blocks/parse/replay "
                             f"{(passes, blocks, parse, replay)}")


def check_against_record(res, rec, what):
    """Same selection as an earlier phase's recorded fit, gains in tolerance."""
    if res.selected_.tolist() != rec["selected"]:
        raise AssertionError(f"{what}: selected {res.selected_.tolist()} vs {rec['selected']}")
    np.testing.assert_allclose(res.gains_, rec["gains"], rtol=RTOL, atol=ATOL, err_msg=what)


def write_csv(path, X, y, chunk=65536):
    """CorrAL rows as CSV text, built with numpy byte operations: one digit a
    field (the values are 0/1), the label last, no header."""
    if X.min() < 0 or X.max() > 9 or y.min() < 0 or y.max() > 9:
        raise ValueError("write_csv writes single-digit values only")
    with open(path, "wb") as f:
        for lo in range(0, len(X), chunk):
            blk = np.concatenate([X[lo:lo + chunk], y[lo:lo + chunk, None]], axis=1)
            buf = np.empty((blk.shape[0], 2 * blk.shape[1]), np.uint8)
            buf[:, 0::2] = blk.astype(np.uint8) + ord("0")
            buf[:, 1::2] = ord(",")
            buf[:, -1] = ord("\n")
            f.write(buf.tobytes())


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*") if p.is_file())


def phase8(dev, launches, fits, keep, tmp):
    """The out-of-core and service surfaces on the card; every temporary
    file and spill directory lives under ``tmp`` (removed after phase 9)."""
    recs = {r["path"]: r for r in fits}
    out = dict(tall=phase8_tall(dev, launches, recs, keep, tmp))
    out["binned"], code_times = phase8_binned(dev, launches, recs, keep, tmp)
    out["csv"] = phase8_csv(dev, launches, out["tall"], keep, tmp)
    out["service"] = phase8_service(dev, launches, tmp)
    out["custom"], custom_times = phase8_custom(dev, launches)
    return out, code_times + custom_times


def phase8_tall(dev, launches, recs, keep, tmp):
    """(a) The tall CorrAL fit streamed through the spill cache with
    read-ahead: pass 1 parses and spills, passes 2..10 replay; then a second
    fit on the same directory parses nothing."""
    from repro_torch import ArraySource, MIScore, MRMRSelector

    X, y = keep["tall"]
    src = ArraySource(X, y)
    t0 = time.perf_counter()
    src.fingerprint()  # the spill entry's key: a content hash of 1 GB (set-up)
    fp_s = time.perf_counter() - t0
    spill = tmp / "spill_tall"

    blocks = -(-len(X) // OOC_BLOCK)  # 16 at 1,000,000 rows

    def fit():
        return MRMRSelector(10, score=MIScore(2, 2), block_obs=OOC_BLOCK, spill_dir=str(spill),
                            readahead=4).fit(src)

    a, arec = spill_fit("ooc_tall_spill", fit, dev, launches)
    check_against_record(a, recs["tall_streaming"], "spilled tall fit vs tall_streaming")
    check_io(a, "spilled tall fit", 10, 10 * blocks, 1, 9)
    counts = launches["ooc_tall_spill"]
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"spilled tall fit launches {counts}")
    if set(arec["count_inputs"]) != {"int8 V=2 C=2"}:
        raise AssertionError(f"spilled tall fit counted {arec['count_inputs']}")
    r, rrec = spill_fit("ooc_tall_replay", fit, dev, launches)
    check_against_record(r, recs["tall_streaming"], "replayed tall fit vs tall_streaming")
    check_io(r, "replayed tall fit", 10, 10 * blocks, 0, 10)
    if launches["ooc_tall_replay"]["contingency_tables"] != 10 * blocks:
        raise AssertionError(f"replayed tall fit launches {launches['ooc_tall_replay']}")
    # Where a replayed fit's time goes: the device's busy share.
    trace = device_breakdown(fit)
    log(f"[ooc] replayed tall fit, traced: {json.dumps(trace)}")
    spilled = dir_bytes(spill)
    log(f"[ooc] tall: fingerprint {fp_s:.3f} s; spill {spilled} bytes on disk; "
        f"fit {arec['seconds']:.3f} s (parse + 9 replays), {rrec['seconds']:.3f} s (10 replays)")
    return dict(spill=str(spill), fingerprint_s=fp_s, spilled_bytes=spilled,
                fit=arec, replay_fit=rrec, replay_trace=trace, selected=a.selected_.tolist(),
                gains=[float(g) for g in a.gains_])


def phase8_binned(dev, launches, recs, keep, tmp):
    """(b) The tall continuous bins=16 fit through the spill cache: the
    staging pass encodes on the host and spills int8 codes, the nine replay
    passes count them; the bin-code kernel does not run.  Then the replayed
    int8 code block's counts, bitwise against the plain version and timed."""
    from repro_torch import BinnedSource, MRMRSelector
    from repro_torch.data.block_cache import BlockCacheSource
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    src = keep["binned_src"]
    spill = tmp / "spill_binned"
    blocks = -(-src.num_obs // OOC_BLOCK)
    res, rec = spill_fit(
        "ooc_binned_spill",
        lambda: MRMRSelector(10, bins=16, block_obs=OOC_BLOCK, spill_dir=str(spill)).fit(src),
        dev, launches)
    check_against_record(res, recs["tall_binned_streaming"],
                         "spilled binned fit vs tall_binned_streaming")
    check_io(res, "spilled binned fit", 10, 10 * blocks, 1, 9)
    counts = launches["ooc_binned_spill"]
    if counts["bin_codes"] != 0:
        raise AssertionError(f"spilled binned fit ran the bin-code kernel: {counts}")
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"spilled binned fit launches {counts}")
    if set(rec["count_inputs"]) != {"int8 V=16 C=2", "int8 V=16 C=16"}:
        raise AssertionError(f"spilled binned fit counted {rec['count_inputs']}")
    cache = res.result_.io["cache"]
    spilled = dir_bytes(spill)
    log(f"[ooc] binned: spilled {cache['parsed_bytes']} bytes of int8 codes and labels "
        f"({spilled} on disk) for {src.X.nbytes + src.y.nbytes} bytes of float32 blocks; "
        f"replayed {cache['replayed_bytes']} bytes")

    # One replayed block, as the replay passes read it (memmapped int8): a
    # hit on the fit's spill entry, not a block staged anew.
    cached = BlockCacheSource(BinnedSource(src, 16, fit_block_obs=OOC_BLOCK), str(spill))
    it = cached.iter_blocks(OOC_BLOCK)
    Xr, yr = next(it)
    it.close()
    if Xr.dtype != np.int8 or Xr.shape != (min(OOC_BLOCK, src.num_obs), src.num_features):
        raise AssertionError(f"replayed codes {Xr.dtype} {Xr.shape}")
    hit = (cached.counters["parse_passes"], cached.counters["replay_passes"])
    if not isinstance(Xr, np.memmap) or hit != (0, 1):
        raise AssertionError(f"the code block is not a replay of the fit's spill: "
                             f"{type(Xr).__name__}, counters {cached.counters}")
    Xd = torch.from_numpy(np.array(Xr)).to(dev)
    code_times = []
    shape = "x".join(map(str, Xr.shape))
    for label, tgt, c in ((f"{shape} int8 codes V=16 C=2 (spilled binned relevance)",
                           torch.from_numpy(np.array(yr)).to(dev, torch.int32), 2),
                          (f"{shape} int8 codes V=16 C=16 (spilled binned redundancy)",
                           Xd[:, 3].to(torch.int32), 16)):
        if not torch.equal(contingency_tables_cuda(Xd, tgt, 16, c),
                           ref.contingency_tables(Xd, tgt, 16, c)):
            raise AssertionError(f"contingency {label}: counts differ")
        log(f"[contingency] {label}: bitwise equal")
        code_times.append(time_contingency(Xd, tgt, 16, c, label, reps=40))
    return dict(fit=rec, parsed_bytes=cache["parsed_bytes"], spilled_bytes=spilled,
                float_bytes=int(src.X.nbytes + src.y.nbytes)), code_times


def phase8_csv(dev, launches, tall, keep, tmp):
    """(c) The tall CorrAL data (all 1,000,000 rows, about 2 GB of text)
    written to CSV and fitted through CSVSource with the spill cache and
    read-ahead: one parse pass, nine replays; the same selection as (a)."""
    from repro_torch import MIScore, MRMRSelector
    from repro_torch.data.sources import CSVSource

    X, y = keep["tall"]
    rows = len(X)
    path = tmp / "corral.csv"
    t0 = time.perf_counter()
    write_csv(path, X, y)
    write_s = time.perf_counter() - t0
    res, rec = spill_fit(
        "ooc_csv",
        lambda: MRMRSelector(10, score=MIScore(2, 2), block_obs=OOC_BLOCK,
                             spill_dir=str(tmp / "spill_csv"), readahead=4).fit(
            CSVSource(str(path), dtype=np.int8, target_dtype=np.int8)),
        dev, launches)
    blocks = -(-rows // OOC_BLOCK)
    check_io(res, "CSV fit", 10, 10 * blocks, 1, 9)
    check_against_record(res, tall, "CSV fit vs (a)")
    counts = launches["ooc_csv"]
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"CSV fit launches {counts}")
    parse_s, replay_s = rec["pass_s"][0], rec["pass_s"][1:]
    log(f"[ooc] csv: {rows} rows, {path.stat().st_size} bytes written in {write_s:.3f} s; "
        f"fit {rec['seconds']:.3f} s; parse pass {parse_s:.3f} s; replay passes "
        f"{json.dumps(replay_s)}")
    return dict(rows=rows, csv_bytes=path.stat().st_size, write_s=write_s,
                parse_pass_s=parse_s, replay_pass_s=replay_s, fit=rec)


def phase8_service(dev, launches, tmp):
    """(d) SelectionService(workers=2) on the card over ``corral:1000000x1000``
    with the spill cache: two identical requests at once run the engine once,
    a distinct one (L=5) runs in the other worker meanwhile, a third identical
    request is a cache hit that launches nothing.  The results equal direct
    streamed fits of the same source with no spill cache, so a fault in the
    service's staging cannot agree with itself.  (The ref names CorralSource's generator, seeded
    by chunk: other rows than phase 3's arrays, so (a)'s fit is repeated on
    them here.)"""
    from repro_torch import CorralSource, MIScore, MRMRSelector
    from repro_torch.serve.selection import SelectionService

    ref, spill = SERVICE_REF, str(tmp / "spill_service")
    knobs = dict(score=MIScore(2, 2), block_obs=OOC_BLOCK, spill_dir=spill)
    rows, cols = (int(v) for v in ref.split(":")[1].split("x"))
    blocks = -(-rows // OOC_BLOCK)
    ids = {}
    barrier = threading.Barrier(2)

    def stampede(svc, i):
        barrier.wait()
        ids[i] = svc.submit(ref, num_select=10, **knobs)

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with SelectionService(workers=2, device="cuda") as svc:
        threads = [threading.Thread(target=stampede, args=(svc, i)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if len(ids) != 2:
            raise AssertionError("the stampede's submissions did not return")
        ids["distinct"] = svc.submit(ref, num_select=5, **knobs)
        res = {k: svc.result(ids[k], timeout=900) for k in (0, 1, "distinct")}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        info = {k: svc.poll(ids[k]).to_dict() for k in (0, 1, "distinct")}
        third = svc.submit(ref, num_select=10, **knobs)
        hit = svc.poll(third).to_dict()
        third_res = svc.result(third, timeout=10)
        stats = svc.stats()
    launches["ooc_service"] = counts
    after = {k: w.launches for k, w in wrappers.items()}
    log(f"[ooc] service: {seconds:.3f} s; launches {json.dumps(counts)}; jobs "
        f"{json.dumps(info)}; third {json.dumps(hit)}; stats {json.dumps(stats)}")
    # Two identical requests, one engine run: (10 + 5) passes of the blocks.
    if counts["contingency_tables"] != (10 + 5) * blocks:
        raise AssertionError(f"service launches {counts}: the stampede ran twice?")
    if stats["coalesced"] != 1 or sum(info[k]["coalesced_into"] is not None for k in (0, 1)) != 1:
        raise AssertionError(f"service coalescing {stats} {info}")
    if not hit["cache_hit"] or hit["attempts"] != 0 or after != counts:
        raise AssertionError(f"third request: {hit}, launches {after} after {counts}")
    primary = 0 if info[0]["coalesced_into"] is None else 1
    d, p = info["distinct"], info[primary]
    overlap = d["started_at"] < p["finished_at"] and p["started_at"] < d["finished_at"]
    if not overlap:
        raise AssertionError(f"the distinct request did not run beside the first: {info}")
    # The results against direct fits of a fresh source: every pass parses
    # (generates) the rows anew; nothing is read from the service's spill.
    t0 = time.perf_counter()
    direct = {L: MRMRSelector(L, score=MIScore(2, 2), block_obs=OOC_BLOCK).fit(
        CorralSource(rows, cols)) for L in (10, 5)}
    direct_s = time.perf_counter() - t0
    for L, fit in direct.items():
        if fit.result_.io.get("cache") is not None or fit.result_.io["passes"] != L:
            raise AssertionError(f"direct L={L} fit io {fit.result_.io}")
    for k, L in ((0, 10), (1, 10), ("distinct", 5)):
        r = res[k]
        if r.selected.tolist() != direct[L].selected_.tolist():
            raise AssertionError(f"service result {k}: {r.selected.tolist()} vs "
                                 f"{direct[L].selected_.tolist()}")
        np.testing.assert_allclose(r.gains.numpy(), direct[L].gains_, rtol=RTOL, atol=ATOL)
    if third_res.selected.tolist() != res[0].selected.tolist():
        raise AssertionError("the cache hit's result differs")
    if set(direct[10].selected_[:9].tolist()) != set(range(9)):
        raise AssertionError(f"service source's first nine picks {direct[10].selected_[:9]}")
    log(f"[ooc] service: direct unspilled fits (L=10, L=5) {direct_s:.3f} s, equal")
    return dict(seconds=seconds, launches=counts, jobs=info, third=hit, stats=stats,
                direct_s=direct_s, selected={str(k): res[k].selected.tolist() for k in res})


def phase8_custom(dev, launches):
    """(e) The paper's custom-score path (Listing 7) on the card: CorrAL
    10,000 x 5,000, mrmr_custom_score(MIScore) on the alternative encoding,
    recomputed every pick.  ``get_result`` is vmapped over candidate chunks
    and each chunk's relevance and redundancy are one launch each of the
    contingency and MI kernels; the fit selects what MIScore selects, with
    what the same vmapped score selects in plain torch (``use_kernel=False``)
    on the same tensors, and reports a NaN relevance."""
    from repro_torch import MIScore, MRMRSelector, mrmr_custom_score
    from repro_torch.core import scores
    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(*CUSTOM_SHAPE, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    L = 5
    custom, rec = run_path(
        "ooc_custom",
        lambda: MRMRSelector(L, score=mrmr_custom_score(MIScore(2, 2)),
                             encoding="alternative").fit(Xd, yd),
        dev, launches)
    m, n = CUSTOM_SHAPE
    chunk = max(1, scores._CUSTOM_CHUNK_ELEMS // (m * (L + 1)))  # candidates a call
    chunks = -(-n // chunk)
    counts = launches["ooc_custom"]
    want = 2 * L * chunks  # a relevance and a redundancy launch a chunk a pick
    if (counts["contingency_tables"], counts["mi_scores"]) != (want, want):
        raise AssertionError(f"custom fit launches {counts}, want {want} of each "
                             f"({chunks} chunks a pick)")
    builtin = MRMRSelector(L, score=MIScore(2, 2), encoding="alternative").fit(Xd, yd)
    check_same_selection(custom, builtin, "CustomScore vs MIScore")
    t0 = time.perf_counter()
    plain = MRMRSelector(L, score=mrmr_custom_score(MIScore(2, 2, use_kernel=False)),
                         encoding="alternative").fit(Xd, yd)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_same_selection(custom, plain, "CustomScore through the kernels vs plain")
    if not np.isnan(custom.scores_).all() or custom.scores_.shape != (n,):
        raise AssertionError("a CustomScore fit's relevance is not all NaN")
    # One pick's full scores, kernels against the plain version.
    Xr = Xd.T.contiguous()
    sel = torch.zeros((L, m), dtype=torch.float32, device=dev)
    sel[:2] = Xr[custom.selected_[:2].tolist()].to(torch.float32)
    got = mrmr_custom_score(MIScore(2, 2)).full_score(Xr, yd, sel, 2)
    ref_scores = mrmr_custom_score(MIScore(2, 2, use_kernel=False)).full_score(Xr, yd, sel, 2)
    np.testing.assert_allclose(got.cpu(), ref_scores.cpu(), rtol=RTOL, atol=ATOL,
                               err_msg="custom full_score, kernels vs plain")
    err = float((got - ref_scores).abs().max())
    log(f"[ooc] custom: {m}x{n}, L={L}, recompute path: {rec['seconds']:.3f} s, peak "
        f"{rec['peak_mem_bytes']} bytes; {chunks} chunks a pick, launches "
        f"{json.dumps(counts)}; the plain vmapped fit {plain_s:.3f} s; one pick's "
        f"scores max abs err {err:.3g}")
    # The count inputs of one chunk, as the vmap rule hands them to the
    # kernel: the candidates' feature-major view against the class, and
    # the selected rows' values fused with each candidate's (x * 2 + v,
    # int32) against one class.
    b = min(chunk, n)
    cands = Xr[:b].T
    fused = (sel.T.to(torch.int32)[:, None, :] * 2 + cands.to(torch.int32)[:, :, None]).flatten(1)
    zero = torch.zeros((m,), dtype=torch.int32, device=dev)
    times = [time_contingency(cands, yd.to(torch.int32), 2, 2,
                              f"{m}x{b} int8 feature-major view (custom relevance chunk)", reps=40),
             time_contingency(fused, zero, 4, 1,
                              f"{m}x{b * L} int32 fused codes, V=4 C=1 (custom redundancy chunk)",
                              reps=40)]
    return dict(rec, plain_s=plain_s, chunks=chunks, max_abs_err=err), times


# -- phase 9: the multi-process map-reduce ------------------------------------

MH_WIDE = (10_000, 50_000)  # phase 4's data
MH_GRID = (40_000, 40_000)  # aspect 1: the automatic rule resolves (2, 2) on 4 hosts
MH_PATHS = ("mh_tall", "mh_wide", "mh_grid")
# block_obs of each run, and each worker's passes and blocks a pass, reckoned
# before the run: (a) L=10 passes of ceil(500,000 / 65,536) = 8 blocks; (b)
# one block of all 10,000 rows, 1 relevance pass + 5 to 9 redundancy passes
# (L-1 = 9 vectors, q=2 a pass, a speculated vector a hit or a miss); (c)
# one block of a host's 20,000 rows, L=5 passes.  (b) and (c) take a block
# of the rows there are: a shorter block is padded to block_obs rows.
MH_BLOCK = dict(mh_tall=65536, mh_wide=MH_WIDE[0], mh_grid=MH_GRID[0] // 2)
MH_EXPECT = dict(mh_tall=((10,), 8), mh_wide=(tuple(range(6, 11)), 1), mh_grid=((5,), 1))


def expected_worker_launches(name, passes, blocks):
    """A worker's (contingency, MI) launches, reckoned from the engine: one
    count a block a candidate, one MI launch a finalised state (two a
    conditional pass: the marginal and the class-major view), per pass."""
    if name == "mh_tall":  # mid, q=1: L passes of ``blocks`` blocks
        return blocks * passes, passes
    if name == "mh_wide":  # q=2: the relevance pass, then 2 states a pass
        return blocks * (2 * passes - 1), 2 * passes - 1
    # jmi, q=1: relevance, then L-1 conditional passes
    return blocks * passes, 1 + 2 * (passes - 1)


def mh_single(name, dev, launches, X, y, L, crit="mid", q=1):
    """The one-process streaming fit on the card that a run is held to:
    the same arrays (in memory), the same knobs."""
    from repro_torch import ArraySource, MIScore, MRMRSelector

    return run_path(f"{name}_single", lambda: MRMRSelector(
        L, score=MIScore(2, 2), block_obs=MH_BLOCK[name], criterion=crit,
        batch_candidates=q, device=dev).fit(ArraySource(X, y)), dev, launches)[1]


def mh_run(name, dev, launches, tmp, X, y, one, hosts, grid, L, extra, crit="mid", q=1):
    """Write (X, y) with ``np.save`` and fit the files through
    ``repro_torch.launch.select_multihost`` with ``hosts`` workers sharing the
    card; held to ``one`` (the record of a one-process fit of the same data):
    the same picks, bitwise the same gains and passes, every worker on the
    card with the launches the engine makes, each host's share of the bytes."""
    from repro_torch.device import device_name

    xp, yp = tmp / f"{name}_X.npy", tmp / f"{name}_y.npy"
    t0 = time.perf_counter()
    np.save(xp, X)
    np.save(yp, y)
    save_s = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "repro_torch.launch.select_multihost",
           "--num-processes", str(hosts), "--input", str(xp), "--target", str(yp),
           "--select", str(L), "--criterion", crit, "--block-obs", str(MH_BLOCK[name]),
           "--batch-candidates", str(q), "--device", dev.type, "--timeout", "300", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name}: the launcher failed (rc={proc.returncode})\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["selected"] != one["selected"]:
        raise AssertionError(f"{name}: selected {out['selected']} vs one process {one['selected']}")
    if out["gains"] != one["gains"]:
        raise AssertionError(f"{name}: gains {out['gains']} are not bitwise the one-process "
                             f"{one['gains']}")
    hosts_io = out["hosts"]
    if hosts_io["grid"] != list(grid):
        raise AssertionError(f"{name}: grid {hosts_io['grid']}, want {list(grid)}")
    agg = hosts_io["aggregate"]
    shares = [h["bytes_read"] / agg["bytes_read"] for h in hosts_io["per_host"]]
    if any(abs(sh - 1 / hosts) > 0.05 for sh in shares):
        raise AssertionError(f"{name}: bytes shares {shares}, want 1/{hosts} +- 0.05")
    counts = dict(contingency_tables=0, mi_scores=0)
    want = {}
    passes_ok, blocks_want = MH_EXPECT[name]
    for pid, w in out["workers"].items():
        io = hosts_io["per_host"][int(pid)]
        if (io["passes"] not in passes_ok or io["passes"] != one["io"]["passes"]
                or io["blocks_read"] != blocks_want * io["passes"]):
            raise AssertionError(f"{name}: worker {pid} ledger {io}, want passes in {passes_ok} "
                                 f"(one process: {one['io']['passes']}) of {blocks_want} blocks")
        want[pid] = dict(zip(("contingency_tables", "mi_scores"),
                             expected_worker_launches(name, io["passes"], blocks_want)))
        if not w["device"].startswith(dev.type) or w["device_name"] != device_name(dev):
            raise AssertionError(f"{name}: worker {pid} ran on {w['device']} {w['device_name']}")
        if w["launches"] != want[pid] or min(w["launches"].values()) == 0:
            raise AssertionError(f"{name}: worker {pid} launches {w['launches']}, want {want[pid]}")
        for k in counts:
            counts[k] += w["launches"][k]
    launches[name] = dict(counts, bin_codes=0, pearson_corr=0, flash_attention=0)
    log(f"[mh] {name}: {hosts} workers on {out['workers']['0']['device']}, grid {hosts_io['grid']}; "
        f"wall {wall:.3f} s (launcher {out['wall_seconds']:.3f} s), slowest worker's fit "
        f"{out['seconds']:.3f} s, one process {one['seconds']:.3f} s; np.save {save_s:.3f} s")
    for pid, w in out["workers"].items():
        log(f"[mh] {name} host {pid}: {json.dumps(hosts_io['per_host'][int(pid)])} "
            f"share {shares[int(pid)]:.4f}; fit {w['seconds']:.3f} s (set-up before it "
            f"{w['setup_seconds']:.3f} s); launches "
            f"{json.dumps(w['launches'])} (reckoned {json.dumps(want[pid])}); windows "
            f"{w['host']['obs_range']} x {w['host']['col_range']}")
    return dict(path=name, hosts=hosts, grid=hosts_io["grid"], block_obs=MH_BLOCK[name],
                wall_s=wall, launcher_wall_s=out["wall_seconds"], slowest_fit_s=out["seconds"],
                single_process_s=one["seconds"], save_s=save_s, per_host=hosts_io["per_host"],
                shares=shares, workers=out["workers"], launches=counts,
                selected=out["selected"], gains=out["gains"])


def phase9(dev, launches, fits, keep, tmp):
    """The paper's multi-process map-reduce on one card: (a) tall, 2 workers,
    grid (2, 1); (b) wide, 2 workers, grid (1, 2), q=2, spill; (c) 2-D, 4
    workers, grid (2, 2), ``jmi``.  N CUDA contexts time-sliced on one device,
    the collectives on the host (gloo): what this measures is the path, not
    cluster scaling.  Then kernel 2 (the class-fused count) at (c)'s block."""
    from repro_torch.data.synthetic import corral_dataset_np

    out = {}
    X, y = keep["tall"]  # phase 3's arrays; its streaming fit is the same fit in one process
    tall_one = next(r for r in fits if r["path"] == "tall_streaming")
    out["tall"] = mh_run("mh_tall", dev, launches, tmp, X, y, tall_one, 2, (2, 1), 10, [])
    X, y = corral_dataset_np(*MH_WIDE, seed=0)
    spill = tmp / "mh_spill"
    one = mh_single("mh_wide", dev, launches, X, y, 10, q=2)
    out["wide"] = mh_run("mh_wide", dev, launches, tmp, X, y, one, 2, (1, 2), 10,
                         ["--spill-dir", str(spill)], q=2)
    entries = sorted(p.name for p in spill.iterdir())
    if len(entries) != 2 or {e.rsplit("-", 1)[1] for e in entries} != {"h0", "h1"}:
        raise AssertionError(f"mh_wide: spill entries {entries}, want one each for h0 and h1")
    log(f"[mh] mh_wide: spill entries {entries}; caches "
        f"{json.dumps({p: w['cache'] for p, w in out['wide']['workers'].items()})}")
    out["wide"]["spill_entries"] = entries
    t0 = time.perf_counter()
    X, y = corral_dataset_np(*MH_GRID, seed=0)
    log(f"[mh] grid data {MH_GRID[0]}x{MH_GRID[1]} int8 made in {time.perf_counter() - t0:.3f} s")
    one = mh_single("mh_grid", dev, launches, X, y, 5, crit="jmi")
    out["grid"] = mh_run("mh_grid", dev, launches, tmp, X, y, one, 4, (2, 2), 5, [], crit="jmi")
    # Kernel 2 at (c)'s redundancy block, as host (0, 0) counts it: its rows
    # and columns, the first pick appended (20,001 one-byte columns: rows
    # aligned to no more than a byte), against that column fused with the
    # class; then the same rows without the appended column.
    rows, cols = MH_GRID[0] // 2, MH_GRID[1] // 2
    c = out["grid"]["selected"][0]
    yb = torch.from_numpy(y[:rows]).to(dev, torch.int32)
    timings = []
    for label, block in ((f"{rows}x{cols + 1} int8 VC=4 (2-D jmi redundancy block, phase 9)",
                          np.concatenate([X[:rows, :cols], X[:rows, c:c + 1]], axis=1)),
                         (f"{rows}x{cols} int8 VC=4 (the same rows, no appended column)",
                          np.ascontiguousarray(X[:rows, :cols]))):
        Xb = torch.from_numpy(block).to(dev)
        timings.append(time_conditional(Xb, Xb[:, c].clone(), yb, label, reps=20))
        del Xb, block
    keep["grid"] = (X, y)  # phase 10's 2-D grid fits the same data
    torch.cuda.empty_cache()
    return out, timings


# -- phase 10: the in-process device mesh -------------------------------------

MESH_PATHS = ("mesh_tall", "mesh_tall_streaming", "mesh_binned_streaming", "mesh_wide",
              "mesh_wide_streaming", "mesh_grid", "mesh_pearson")


def expected_mesh_launches(name, passes, blocks=1):
    """A mesh run's (contingency, MI) launches, reckoned from the engine: one
    count a shard (a tile) a pass, streamed a tile a block; MI once a
    feature group a pass (a conditional pass twice: the marginal and the
    class-major view)."""
    if name == "mesh_tall":  # (4,) data: 4 shards a pass, one feature group
        return 4 * passes, passes
    if name == "mesh_wide":  # (4,) model: 4 shards, each its own group
        return 4 * passes, 4 * passes
    if name == "mesh_grid":  # (2, 2) jmi: 4 tiles; 2 groups, 1 + 2 MI a pass each
        return 4 * passes, 2 + 2 * 2 * (passes - 1)
    if name == "mesh_tall_streaming":  # (2,) data: 2 tiles a block, one group
        return 2 * blocks * passes, passes
    if name == "mesh_wide_streaming":  # (2,) model: 2 tiles a block, 2 groups
        return 2 * blocks * passes, 2 * passes
    if name == "mesh_binned_streaming":  # (3,) model: 3 tiles a block, 3 groups
        return 3 * blocks * passes, 3 * passes
    raise KeyError(name)


def phase10(dev, launches, fits, keep):
    """The in-process device mesh on one card: meshes of 2 or 4 positions,
    every one ``cuda:0``, so the shards run one after another on one stream.
    (a) phase 3's tall data on (4,) data; (b) phase 4's wide data on (4,)
    model; (c) phase 9's 40,000 x 40,000 ``jmi`` L=5 on a (2, 2) grid; (d)
    phase 3's data streamed at 65,536 rows on (2,) data; (e) phase 4's data
    streamed at 10,000 rows on (2,) model, the state feature-sharded; (f)
    phase 6's continuous data, Pearson, on (2,) model; (g) phase 5's
    continuous data, bins=16, L=4, streamed on (3,) model with the edges
    feature-sharded.  Each is held to the one-device card fit of the same
    data (picks equal, MI gains bitwise,
    Pearson within ``CORR_RTOL``/``CORR_ATOL``) and to its launches; then
    the new per-shard kernel shapes are timed.  A path, not a speed-up: no
    gain is claimed."""
    from repro_torch import ArraySource, MIScore, MRMRSelector
    from repro_torch.dist.meshes import make_mesh

    def mesh(shape, axes):
        return make_mesh(shape, axes, devices=[dev] * 4)

    one = {r["path"]: r for r in fits}
    out, timings = {}, []

    def held(name, rec, ref, exact=True):
        if rec["selected"] != ref["selected"]:
            raise AssertionError(f"{name}: selected {rec['selected']} vs one device "
                                 f"{ref['selected']}")
        if exact and rec["gains"] != ref["gains"]:
            raise AssertionError(f"{name}: gains {rec['gains']} are not bitwise the one-device "
                                 f"{ref['gains']}")
        if not exact:
            np.testing.assert_allclose(rec["gains"], ref["gains"], rtol=CORR_RTOL,
                                       atol=CORR_ATOL, err_msg=name)

    def counted(name, want):
        got = (launches[name]["contingency_tables"], launches[name]["mi_scores"])
        if got != want:
            raise AssertionError(f"{name}: launches {launches[name]}, reckoned {want}")
        log(f"[mesh] {name}: contingency, MI launches {got} as reckoned")

    def plan_of(name, res, encoding, shape):
        p = res.plan_
        if (p.encoding, p.mesh_shape, res.mesh_.size) != (encoding, shape, int(np.prod(shape))):
            raise AssertionError(f"{name}: plan {p.encoding} {p.mesh_shape} on {res.mesh_}")
        if {str(d) for d in res.mesh_.devices.flat} != {str(dev)}:
            raise AssertionError(f"{name}: mesh positions {res.mesh_}")

    # (a) tall in memory and (d) streamed, phase 3's arrays
    X, y = keep["tall"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((4,), ("data",))
    res, rec = run_path("mesh_tall", lambda: MRMRSelector(10, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_tall", res, "conventional", (4,))
    held("mesh_tall", rec, one["tall_conventional"])
    counted("mesh_tall", expected_mesh_launches("mesh_tall", 10))
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10, mesh=m).fit(Xd, yd))
    log(f"[mesh] warm (4,) data fit, traced: {json.dumps(rec['trace'])}")
    out["tall"] = dict(rec, single_s=one["tall_conventional"]["seconds"])
    timings.append(time_contingency(Xd[:250_000], yd[:250_000], 2, 2,
                                    "250000x1000 int8 (a (4,) data shard, phase 10)", flush=True))
    timings.append(time_contingency(Xd[:32768], yd[:32768], 2, 2,
                                    "32768x1000 int8 (half a streamed block, phase 10)", reps=40, flush=True))
    del Xd, yd
    m = mesh((2,), ("data",))
    res, rec = run_path("mesh_tall_streaming", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=65536, mesh=m).fit(ArraySource(X, y)), dev, launches)
    plan_of("mesh_tall_streaming", res, "streaming", (2,))
    held("mesh_tall_streaming", rec, one["tall_streaming"])
    blocks = -(-X.shape[0] // 65536)  # 16 at 1,000,000 rows
    if (rec["io"]["passes"], rec["io"]["blocks_read"]) != (10, 10 * blocks):
        raise AssertionError(f"mesh_tall_streaming ledger {rec['io']}")
    counted("mesh_tall_streaming", expected_mesh_launches("mesh_tall_streaming", 10, blocks))
    out["tall_streaming"] = dict(rec, single_s=one["tall_streaming"]["seconds"])

    # (g) phase 5's continuous data, bins=16, streamed on (3,) model: the
    # fitted edges cut into three feature shards (1000 columns padded to
    # 1002: the last shard's two edge rows +inf), each block's tiles encoded
    # on their position, once a tile a block.  Cut to L=4 (the host copies
    # a block's column tiles, 2.3x phase 5's fit at L=10): its picks and
    # gains are the first 4 of phase 5's L=10 fit, whose greedy steps they are.
    src, depth = keep["binned_src"], 4
    m = mesh((3,), ("model",))
    res, rec = run_path("mesh_binned_streaming", lambda: MRMRSelector(
        depth, bins=16, block_obs=65536, mesh=m).fit(src), dev, launches)
    plan_of("mesh_binned_streaming", res, "streaming", (3,))
    if (res.plan_.bins, res.plan_.feat_axes) != (16, ("model",)):
        raise AssertionError(f"mesh_binned_streaming: plan {res.plan_}")
    ref5 = one["tall_binned_streaming"]
    held("mesh_binned_streaming", rec, dict(selected=ref5["selected"][:depth],
                                            gains=ref5["gains"][:depth]))
    if (rec["io"]["passes"], rec["io"]["blocks_read"]) != (depth, depth * blocks):
        raise AssertionError(f"mesh_binned_streaming ledger {rec['io']}")
    counted("mesh_binned_streaming",
            expected_mesh_launches("mesh_binned_streaming", depth, blocks))
    if launches["mesh_binned_streaming"]["bin_codes"] != 3 * blocks * depth:
        raise AssertionError(f"mesh_binned_streaming: bin_codes launches "
                             f"{launches['mesh_binned_streaming']}, reckoned {3 * blocks * depth}")
    out["binned_streaming"] = dict(rec, single_s=one["tall_binned_streaming"]["seconds"])
    # The last tile's encode: 332 columns and 2 padded ones, their edges +inf.
    rng = np.random.default_rng(10)
    Xt, et = planted_block(rng, 65536, 332, 15)
    Xt = np.concatenate([Xt, np.zeros((65536, 2), np.float32)], axis=1)
    et = np.concatenate([et, np.full((2, 15), np.inf, np.float32)])
    Xtd, etd = torch.from_numpy(Xt).to(dev), torch.from_numpy(et).to(dev)
    bin_times = [check_bins(Xtd, etd, "65536x334 E=15, the last 2 edge rows +inf (the last "
                            "tile of a (3,) model mesh, phase 10)", reps=40)]
    del Xtd, etd

    # (b) wide in memory and (e) streamed, phase 4's arrays
    X, y = keep["wide"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((4,), ("model",))
    res, rec = run_path("mesh_wide", lambda: MRMRSelector(10, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_wide", res, "alternative", (4,))
    held("mesh_wide", rec, one["wide_alternative"])
    counted("mesh_wide", expected_mesh_launches("mesh_wide", 10))
    out["wide"] = dict(rec, single_s=one["wide_alternative"]["seconds"])
    for lo in (0, 12_500):  # shard 0, and shard 1: its rows start 12,500 bytes in
        timings.append(time_contingency(
            Xd[:, lo:lo + 12_500], yd, 2, 2, f"10000x12500 int8 column window at column {lo} "
            f"(a (4,) model shard of the 10000x50000 matrix, phase 10)", flush=True))
    del Xd, yd
    m = mesh((2,), ("model",))
    _, single = run_path("mesh_wide_streaming_single", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=10_000).fit(ArraySource(X, y)), dev, launches)
    res, rec = run_path("mesh_wide_streaming", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=10_000, mesh=m).fit(ArraySource(X, y)), dev, launches)
    plan_of("mesh_wide_streaming", res, "streaming", (2,))
    held("mesh_wide_streaming", rec, single)
    if rec["selected"] != one["wide_alternative"]["selected"]:
        raise AssertionError("mesh_wide_streaming: picks differ from phase 4's in-memory fit")
    counted("mesh_wide_streaming", expected_mesh_launches("mesh_wide_streaming", 10, 1))
    out["wide_streaming"] = dict(rec, single_s=single["seconds"])

    # (c) the 2-D grid, phase 9's 40,000 x 40,000 arrays, jmi L=5
    X, y = keep["grid"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    _, single = run_path("mesh_grid_single", lambda: MRMRSelector(5, criterion="jmi").fit(Xd, yd),
                         dev, launches)
    m = mesh((2, 2), ("data", "model"))
    inputs: dict = {}
    with tally_count_inputs(inputs):
        res, rec = run_path("mesh_grid", lambda: MRMRSelector(
            5, criterion="jmi", encoding="grid", mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_grid", res, "grid", (2, 2))
    held("mesh_grid", rec, single)
    counted("mesh_grid", expected_mesh_launches("mesh_grid", 5))
    if inputs.get("int8 V=2 C=4") != 16:
        raise AssertionError(f"mesh_grid: counts by input {inputs}, want 16 class-fused")
    log(f"[mesh] mesh_grid: contingency launches by input {json.dumps(inputs)}")
    out["grid"] = dict(rec, single_s=single["seconds"], count_inputs=inputs)
    rows, cols = MH_GRID[0] // 2, MH_GRID[1] // 2
    c = rec["selected"][0]
    timings.append(time_conditional(
        Xd[:rows, :cols], Xd[:rows, c].clone(), yd[:rows],
        f"{rows}x{cols} int8 VC=4 (a (2, 2) grid tile, a view with rows 16-byte aligned, "
        "phase 10)", reps=20))
    del Xd, yd

    # (f) Pearson, phase 6's arrays, on (2,) model
    X, y = keep["pearson"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((2,), ("model",))
    res, rec = run_path("mesh_pearson", lambda: MRMRSelector(8, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_pearson", res, "alternative", (2,))
    held("mesh_pearson", rec, one["wide_pearson"], exact=False)
    if launches["mesh_pearson"]["pearson_corr"] != 16:  # 2 shards x (1 relevance + 7 folds)
        raise AssertionError(f"mesh_pearson launches {launches['mesh_pearson']}")
    out["pearson"] = dict(rec, single_s=one["wide_pearson"]["seconds"])
    del Xd, yd
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"[mesh] {name}: fit {r['seconds']:.3f} s on {r['path']}, the one-device card "
            f"fit {r['single_s']:.3f} s")
    return out, timings, bin_times


def kernel_entry(name, source, replaces, paths, launches, err, head, shapes):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=sum(launches[p][name] for p in paths),
                launches_by_path={p: launches[p][name] for p in paths},
                max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], at_shapes=shapes)


def main():
    t_start = time.perf_counter()
    smi = phase0()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass, base = phase1()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name} {time.perf_counter() - t0:.3f} s")
        return out

    count_err, mi_err = phase("2 contingency+mi", phase2, dev)
    plan_paths = dict(contingency=phase("2 contingency plan paths", contingency_paths, dev),
                      bin_codes=phase("2 bin_codes plan paths", bin_codes_paths, dev))
    code_times = phase("2 contingency int32 codes", phase2_codes, dev)
    bins_err, bin_times = phase("2 bin_codes", phase2_bins, dev)
    corr_err, corr_times = phase("2 pearson_corr", phase2_pearson, dev)
    flash_err, flash_times = phase("2 flash_attention", phase2_flash, dev)
    launches: dict = {}
    timings: list = []
    keep: dict = {}
    fits = phase("3 tall", phase3, dev, launches, timings, keep)
    fits += phase("4 wide", phase4, dev, launches, timings, keep)
    gen = torch.Generator(device=dev).manual_seed(4)
    Xc = (torch.rand((65536, 1000), generator=gen, device=dev) < 0.5).to(torch.int8)
    timings.append(time_conditional(Xc, Xc[:, 3].clone(), Xc[:, 5].to(torch.int32),
                                    "65536x1000 int8 VC=4 (conditional)"))
    del Xc
    fits += phase("5 tall binned", phase5, dev, launches, keep)
    fits += phase("6 wide pearson", phase6, dev, launches, keep)
    serves, serve_check = phase("7 yi-6b serve", phase7, dev, launches)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ooc_"))
    try:
        ooc, spilled_code_times = phase("8 out-of-core", phase8, dev, launches, fits, keep, tmp)
        code_times += spilled_code_times
        mh, mh_times = phase("9 multi-host", phase9, dev, launches, fits, keep, tmp)
        timings += mh_times
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if tmp.exists():
        raise AssertionError(f"phases 8 and 9 left {tmp} behind")
    mesh_fits, mesh_times, mesh_bin_times = phase("10 device mesh", phase10, dev, launches,
                                                  fits, keep)
    timings += mesh_times
    bin_times += mesh_bin_times
    bins_err = max([bins_err] + [r["max_abs_err"] for r in mesh_bin_times])
    del keep
    rng = np.random.default_rng(1)

    def tables(*shape):
        return torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)

    mi_block = tables(1000, 2, 2)
    mi_times = [time_mi(t, label, base, MI_TALLY) for t, label in [
        (mi_block, "1000x2x2 (tall pass)"),
        (mi_block.repeat(50, 1, 1), "50000x2x2 (wide pass)"),
        (tables(1000, 16, 2), "1000x16x2 (binned relevance)"),
        (tables(1000, 16, 16), "1000x16x16 (binned redundancy)"),
        (tables(1000, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 1000x2x2x2 stack (jmi/cmim redundancy)"),
        (tables(20001, 2, 2), "20001x2x2 (2-D jmi marginal, phase 9)"),
        (tables(12500, 2, 2), "12500x2x2 (a (4,) model shard's pass, phase 10)"),
        (tables(20000, 2, 2), "20000x2x2 (a (2, 2) grid's feature group, jmi marginal, phase 10)"),
        (tables(20000, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 20000x2x2x2 stack (the grid's jmi redundancy, phase 10)"),
        (tables(20001, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 20001x2x2x2 stack (2-D jmi redundancy, phase 9)"),
        (tables(279, 1, 2, 2), "279x1x2x2 (custom relevance chunk)"),
        (tables(279, 5, 2, 2), "279x5x2x2 (custom redundancy chunk)")]]
    log(f"[mi] main-path launches by table shape: {json.dumps({str(k): n for k, n in MI_TALLY.items()})}")

    mi_err = max([mi_err] + [r["max_abs_err"] for r in mi_times])
    mi_paths = ("tall_conventional", "tall_streaming", "wide_alternative",
                "tall_binned_streaming", "tall_binned_in_memory", *OOC_PATHS, *MH_PATHS,
                *MESH_PATHS)
    kernels = [
        # the streaming block: the shape launched most often
        kernel_entry("contingency_tables", "src/repro_torch/csrc/contingency.cu",
                     "src/repro/kernels/contingency.py:59", mi_paths, launches,
                     count_err, timings[1], timings + code_times),
        kernel_entry("mi_scores", "src/repro_torch/csrc/mi_score.cu",
                     "src/repro/kernels/mi_score.py:40", mi_paths, launches,
                     mi_err, mi_times[0], mi_times),
        kernel_entry("bin_codes", "src/repro_torch/csrc/bin_codes.cu",
                     "src/repro/kernels/binning.py:45",
                     ("tall_binned_streaming", "tall_binned_in_memory", "mesh_binned_streaming"),
                     launches,
                     bins_err, bin_times[0], bin_times),
        kernel_entry("pearson_corr", "src/repro_torch/csrc/pearson.cu",
                     "src/repro/kernels/pearson.py:57", ("wide_pearson", "mesh_pearson"), launches,
                     corr_err, corr_times[0], corr_times),
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:79", ("yi6b_serve",), launches,
                     flash_err, flash_times[0], flash_times),
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on a main path")
    log(json.dumps(dict(fits=fits, serves=serves, serve_check=serve_check, sass=sass,
                        plan_paths=plan_paths, out_of_core=ooc, multi_host=mh,
                        device_mesh=mesh_fits)))
    log(f"[total] {time.perf_counter() - t_start:.3f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the ``repro_torch`` port on one NVIDIA GPU and hold it to its kernels.

    python3 chip_smoke.py

Phases (each failure raises; the script exits non-zero and prints no result):

0. The card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
   No CUDA device -> exit 1.
1. Build every CUDA source of the port with ``nvcc`` (one process per
   source, all started together); print the build time and ``-Xptxas -v``.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: contingency counts bitwise equal (int8/int16/int32, the
   class-fused conditional target, a ragged row count, injected negatives and
   sentinels); MI within ``rtol=1e-5, atol=1e-6``.  Times with CUDA events:
   kernel, plain version, the byte/operation bound and, for contingency,
   ``torch.bincount`` on the fused index as the library yardstick.
3. Tall (the paper's Fig. 5/6 point): CorrAL 1,000,000 x 1000 int8, L=10,
   ``mid``.  The in-memory fit (plans ``conventional``), the streaming fit
   over ``ArraySource`` at ``block_obs=65536`` and the in-memory fit with the
   plain versions (``use_kernel=False``) must select the same features, the
   first nine being {0..8}; the streaming ledger must read 10 passes and 160
   blocks.
4. Wide (the repo's scaled Fig. 7 point): CorrAL 10,000 x 50,000, L=10,
   plans ``alternative``; kernels and plain versions select the same.

Each main-path fit runs with the kernels' launch counts set to 0 just before
it and read just after: an in-memory fit of L=10 counts 10 contingency
launches (1 relevance + 9 folds; no fold follows the last pick), the
streaming fit 160 (10 passes x 16 blocks), and every fit launches the MI
kernel.  The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and the SMs'
# 32-bit non-tensor rate for the integer compare-and-count and float work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
RTOL, ATOL = 1e-5, 1e-6


def log(*parts):
    print(*parts, flush=True)


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


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over HBM rate vs
    operations over the scalar rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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


def phase1():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.3f} s")
    for name, out in _build.build_log.items():
        log(f"[build] {name}:\n{out}")


def phase2(dev):
    from repro_torch.core.contingency import OOR
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda
    from repro_torch.kernels.mi_score import mi_scores_cuda

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

    mi_err = 0.0
    for shape in [(1000, 2, 2), (1000, 2, 4), (50000, 2, 2)]:
        counts = torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)
        counts[::11] = 0  # all-zero rows
        got = mi_scores_cuda(counts)
        want = ref.mi_scores(counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if not torch.all(got[::11] == 0):
            raise AssertionError("MI of an all-zero table is not 0")
        mi_err = max(mi_err, (got - want).abs().max().item())
        log(f"[mi] {shape}: within rtol={RTOL} atol={ATOL}, "
            f"max abs err {(got - want).abs().max().item():.3e}")
    return count_err, mi_err


def time_contingency(X, y, v, c, label, reps=10):
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    m, f = X.shape
    ms = cuda_ms(lambda: contingency_tables_cuda(X, y, v, c), reps)
    plain_ms = cuda_ms(lambda: ref.contingency_tables(X, y, v, c), max(2, reps // 5), 1)
    if not torch.equal(bincount_tables(X, y, v, c),
                       contingency_tables_cuda(X, y, v, c)):
        raise AssertionError(f"bincount yardstick disagrees at {label}")
    library_ms = cuda_ms(lambda: bincount_tables(X, y, v, c), max(2, reps // 5), 1)
    nbytes = X.numel() * X.element_size() + y.numel() * y.element_size() + f * v * c * 4
    b_ms, b_by = bound(nbytes, m * f)
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, bytes=nbytes)
    log(f"[time] contingency {label}: {json.dumps(rec)}")
    return rec


def time_mi(counts, label, reps=50):
    from repro_torch.kernels import ref
    from repro_torch.kernels.mi_score import mi_scores_cuda

    f, v, c = counts.shape
    ms = cuda_ms(lambda: mi_scores_cuda(counts), reps)
    plain_ms = cuda_ms(lambda: ref.mi_scores(counts), reps)
    nbytes = counts.numel() * counts.element_size() + f * 4
    b_ms, b_by = bound(nbytes, f * v * c * (v + 8))
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, bytes=nbytes)
    log(f"[time] mi {label}: {json.dumps(rec)}")
    return rec


def run_path(name, fn, dev, launches):
    """Drive one main-path fit with the launch counts zeroed just before
    and read just after; returns (result, record)."""
    from repro_torch.kernels.contingency import contingency_tables_cuda
    from repro_torch.kernels.mi_score import mi_scores_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    contingency_tables_cuda.launches = 0
    mi_scores_cuda.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(contingency_tables=contingency_tables_cuda.launches,
                  mi_scores=mi_scores_cuda.launches)
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


def phase3(dev, launches, timings):
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
    return [rec, srec, prec]


def phase4(dev, launches, timings):
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
    return [rec, prec]


def main():
    smi = phase0()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1()
    count_err, mi_err = phase2(dev)
    launches: dict = {}
    timings: list = []
    fits = phase3(dev, launches, timings)
    fits += phase4(dev, launches, timings)
    rng = np.random.default_rng(1)
    mi_block = torch.as_tensor(rng.integers(0, 30000, (1000, 2, 2))).to(torch.int32).to(dev)
    mi_times = [time_mi(mi_block, "1000x2x2 (tall pass)"),
                time_mi(mi_block.repeat(50, 1, 1), "50000x2x2 (wide pass)")]

    kernel_paths = ("tall_conventional", "tall_streaming", "wide_alternative")
    head_c = timings[1]  # the streaming block: the shape launched most often
    head_m = mi_times[0]
    kernels = [
        dict(name="contingency_tables", route="cuda",
             source="src/repro_torch/csrc/contingency.cu",
             replaces="src/repro/kernels/contingency.py:59",
             launches=sum(launches[p]["contingency_tables"] for p in kernel_paths),
             launches_by_path={p: launches[p]["contingency_tables"] for p in kernel_paths},
             max_abs_err=count_err,
             ms=head_c["ms"], plain_ms=head_c["plain_ms"],
             bound_ms=head_c["bound_ms"], bound_by=head_c["bound_by"],
             library_ms=head_c["library_ms"], at_shapes=timings),
        dict(name="mi_scores", route="cuda",
             source="src/repro_torch/csrc/mi_score.cu",
             replaces="src/repro/kernels/mi_score.py:40",
             launches=sum(launches[p]["mi_scores"] for p in kernel_paths),
             launches_by_path={p: launches[p]["mi_scores"] for p in kernel_paths},
             max_abs_err=mi_err,
             ms=head_m["ms"], plain_ms=head_m["plain_ms"],
             bound_ms=head_m["bound_ms"], bound_by=head_m["bound_by"],
             library_ms=None, at_shapes=mi_times),
    ]
    log(json.dumps(dict(fits=fits)))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 mrmr_bench/run.py --workload tall.mid --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  Exits non-zero, printing no result, where
torch sees fewer CUDA devices than the cell asks for, where the program
(``src/repro_torch``) is missing, or where JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there builds.  The program's own nvcc builds land in
# src/repro_torch/build/.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
# One host thread for the CPU work, so that the run's own threads do not
# contend for the machine's cores.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def keep_bytecode() -> None:
    """Where torch is installed without compiled bytecode (and cannot take
    it), keep the bytecode of every module this run imports in the
    checkout, so that only a cell's first run there compiles it."""
    spec = importlib.util.find_spec("torch")
    if spec is None or spec.origin is None:
        return
    if not os.path.exists(importlib.util.cache_from_source(spec.origin)):
        sys.pycache_prefix = str(CACHE / "pycache")
        sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("the program is missing: no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    keep_bytecode()
    import torch

    from mrmr_bench import harness

    cell = harness.load_cell(args.workload, ROOT)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

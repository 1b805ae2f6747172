"""Build the CUDA sources in ``repro_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for Hopper
(``sm_90a``), into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The library lands in ``repro_torch/build/<name>-<hash>/`` (listed in
``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built when a
module is imported: :func:`load` builds at first use, and
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them (what ``chip_smoke.py`` times). Both hold one lock, so threads
that first launch kernels at the same time build each source once. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from repro_torch.analysis.op_analysis import charge_kernel

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C signature of every entry point: argtypes (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits) and an int return,
# the cudaGetLastError() code of the launch.
SIGNATURES = {
    "contingency": {
        "contingency_tables_launch": (
            _P, _I, _I64, _I64, _I64, _I64, _P, _I, _I, _I, _I, _I, _I, _I,
            _I64, _I64, _I64, _I, _I, _P, _P,
        ),
    },
    "mi_score": {
        "mi_scores_launch": (
            _P, _I, _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _I, _I,
            _P, _P, _P,
        ),
    },
    "bin_codes": {
        "bin_codes_launch": (
            _P, _I64, _I64, _I64, _P, _I, _I, _I, _I64, _I64, _I64, _I, _P, _P,
        ),
    },
    "pearson": {
        "pearson_corr_launch": (
            _P, _I64, _I64, _I64, _P, _I, _I64, _P, _P, _I, _I, _I, _P,
        ),
    },
    "flash_attention": {
        "flash_attention_launch": (
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I, _P,
        ),
    },
}

_LOCK = threading.Lock()
_LOADED: dict = {}
# Compiler output (-Xptxas -v register and shared-memory report) by source.
build_log: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit"
        )
    return str(path)


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{key}" / f"lib{name}.so"


def _start(name: str, lib: pathlib.Path) -> subprocess.Popen:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, lib: pathlib.Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_log[name] = out
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees a half-written library


def build_all(names=None) -> dict:
    """Compile every source (or ``names``) that has no current build, one
    ``nvcc`` per source started together; returns ``{name: library path}``."""
    names = list(SIGNATURES) if names is None else list(names)
    with _LOCK:
        libs = {n: _lib_path(n) for n in names}
        procs = {n: _start(n, p) for n, p in libs.items() if not p.exists()}
        try:
            for n, proc in procs.items():
                _finish(n, libs[n], proc)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return libs


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
    return lib


_SMS: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device``, read once per device
    (the persistent kernels size their grids from it on every launch)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, flops: float = 0.0, nbytes: float = 0.0) -> None:
    """Add one to ``wrapper.launches`` (a read, add and store) under a lock:
    worker threads of the selection service launch kernels at once, and an
    unlocked ``+=`` can lose a count between threads.  The launch's charge
    (its operations and the bytes it must move: each input read once, the
    output written once) goes to the open cost counter
    (:mod:`repro_torch.analysis.op_analysis`)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
    charge_kernel(kernel_name(wrapper), flops, nbytes)


def kernel_name(wrapper) -> str:
    """``flash_attention`` for ``flash_attention_cuda``."""
    return wrapper.__name__.removesuffix("_cuda")


def meta_result(wrapper, shape, dtype, flops: float, nbytes: float) -> torch.Tensor:
    """A kernel's stand-in on ``meta`` tensors (the dry run): its output's
    shape and dtype, and its charge to the open cost counter; no launch is
    counted."""
    charge_kernel(kernel_name(wrapper), flops, nbytes)
    return torch.empty(shape, dtype=dtype, device="meta")


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Multi-host feature selection — one process per shard, on one machine or many.

Spawn mode (the default) stands up an N-process ``torch.distributed`` group
on this machine — a free loopback port, N child processes of this module
started with ``subprocess`` (never ``fork``), gloo collectives — runs the
SAME selection in every process with ``MRMRSelector(hosts="auto")``, checks
that every host committed the same picks and gains, and prints one merged
JSON line:

    # 2 processes over a memmapped .npy; each reads only its shard
    PYTHONPATH=src python -m repro_torch.launch.select_multihost \\
        --num-processes 2 --input X.npy --target y.npy --select 10

    # CorrAL data, wide regime, spill + batching, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.select_multihost \\
        --num-processes 2 --rows 200 --cols 2048 --select 8 \\
        --batch-candidates 4 --spill-dir /tmp/spill --device cpu

Worker mode (``--process-id`` set, as spawn mode sets it for its children)
joins the group, fits, and prints this host's result — how a real cluster
runs it: one invocation per machine with ``--coordinator host0:port
--num-processes N --process-id i`` (or the ``REPRO_COORDINATOR`` /
``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables).

``--device cuda`` (the default) puts process ``i`` on card ``i % cards``:
on a one-card machine every worker shares ``cuda:0``, each with its own
CUDA context, and the collectives go through the host.  Spawn mode builds
the kernels once before it starts the workers.  Without a card each worker
raises and the launcher fails; nothing falls back to the CPU.

Every host returns the same selection — the per-pass reduce is a collective
sum of exact integer statistics, so there is no master to gather from; the
cross-host check tests a guarantee.  A worker's JSON adds the name of its
device, its contingency and MI kernel launches during the fit, the fit's
seconds and the seconds before it (joining the group, the device context and
a first count and MI call, the source).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

_MARK = "MHRESULT:"
_SRC = str(pathlib.Path(__file__).resolve().parents[2])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's rendezvous (spawn mode "
                         "picks a free loopback port when omitted)")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id 0..N-1; omitting it runs spawn "
                         "mode, which launches all N workers locally")
    ap.add_argument("--input", default=None,
                    help=".npy matrix (see --target), .csv or .parquet; "
                         "default = synthetic CorrAL-style data")
    ap.add_argument("--target", default=None,
                    help="target-vector .npy for a .npy --input")
    ap.add_argument("--rows", type=int, default=6000)
    ap.add_argument("--cols", type=int, default=24)
    ap.add_argument("--select", type=int, default=4)
    ap.add_argument("--criterion", default="mid")
    ap.add_argument("--score", default="mi", choices=["mi", "pearson"])
    ap.add_argument("--num-values", type=int, default=2)
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--block-obs", type=int, default=65536)
    ap.add_argument("--batch-candidates", type=int, default=1)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--readahead", type=int, default=0)
    ap.add_argument("--bins", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (process i on card i %% cards; raises without "
                         "a card) or cpu (the kernels' plain versions)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds: the process group's rendezvous and each "
                         "collective, and spawn mode's wait for its workers")
    return ap


def _load_source(args):
    """The worker's DataSource — every host builds the SAME source (same
    paths, same synthetic seed); the HostShardSpec decides which rows and
    columns of it this host actually reads."""
    import numpy as np

    from repro_torch.data.sources import ArraySource, CSVSource, NpySource

    if args.input is None:
        from repro_torch.data.synthetic import corral_dataset_np

        X, y = corral_dataset_np(args.rows, args.cols, seed=args.seed)
        if args.score == "pearson" or args.bins:
            X = X.astype(np.float32)
        return ArraySource(X, y)
    if args.input.endswith(".npy"):
        if not args.target:
            raise SystemExit("--target <y.npy> is required with a .npy input")
        return NpySource(args.input, args.target)
    if args.input.endswith(".csv"):
        dtype = np.int32 if args.score == "mi" and not args.bins else np.float32
        return CSVSource(args.input, dtype=dtype)
    if args.input.endswith(".parquet"):
        from repro_torch.data.sources import ParquetSource

        return ParquetSource(args.input)
    raise SystemExit(f"unsupported --input {args.input!r}")


def _worker_device(name: str, process_id: int):
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _run_worker(args) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core.scores import MIScore, PearsonMIScore
    from repro_torch.core.selector import MRMRSelector
    from repro_torch.device import device_name
    from repro_torch.dist.multihost import init_multihost
    from repro_torch.kernels import ops
    from repro_torch.kernels.contingency import contingency_tables_cuda
    from repro_torch.kernels.mi_score import mi_scores_cuda

    t_start = time.perf_counter()
    ctx = init_multihost(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        timeout=args.timeout,
    )
    dev = _worker_device(args.device, ctx.process_id)
    # One count and one MI call before the fit is timed: the device context,
    # the kernels' libraries and torch's lazily imported operator machinery
    # are set up once a process, not work of the fit.
    one = torch.zeros((1, 1), dtype=torch.int8, device=dev)
    ops.mi_scores(ops.contingency_tables(one, one[:, 0].to(torch.int32), 2, 2))
    if args.bins:
        score = None
    elif args.score == "mi":
        score = MIScore(num_values=args.num_values, num_classes=args.num_classes)
    else:
        score = PearsonMIScore()
    source = _load_source(args)
    sel = MRMRSelector(
        num_select=args.select,
        score=score,
        criterion=args.criterion,
        block_obs=args.block_obs,
        batch_candidates=args.batch_candidates,
        spill_dir=args.spill_dir,
        readahead=args.readahead,
        bins=args.bins or None,
        hosts="auto",
        device=dev,
    )
    wrappers = dict(contingency_tables=contingency_tables_cuda, mi_scores=mi_scores_cuda)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    setup_seconds = t0 - t_start
    sel.fit(source)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return dict(
        process_id=ctx.process_id,
        num_processes=ctx.num_processes,
        device=str(dev),
        device_name=device_name(dev),
        launches=launches,
        selected=sel.selected_.tolist(),
        gains=[float(g) for g in sel.gains_],
        criterion=sel.result_.criterion,
        io=sel.result_.io,
        seconds=seconds,
        setup_seconds=setup_seconds,
    )


def _wait(procs, timeout: float) -> None:
    """Wait for every worker; the first one to fail (or the deadline) ends
    the others, so a lost peer never leaves its partners hanging."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _spawn(args, argv) -> dict:
    if args.device.startswith("cuda"):
        import torch

        if torch.cuda.is_available():
            # One build before the workers start; each would otherwise
            # compile the same sources at once.
            from repro_torch.kernels import _build

            _build.build_all()
    coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # Children resolve their place from argv, not env: drop any inherited
    # multi-host variables so a nested launch cannot cross wires.
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, env.get("PYTHONPATH")) if p
    )
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for pid in range(args.num_processes):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.select_multihost",
                 *argv, "--coordinator", coordinator, "--process-id", str(pid)],
                env=env, stdout=out, stderr=err, text=True,
            ))
        _wait(procs, args.timeout)
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
    wall = time.perf_counter() - t0
    results, failed = {}, []
    for pid, (p, (out, err)) in enumerate(zip(procs, texts)):
        payload = next(
            (l[len(_MARK):] for l in out.splitlines() if l.startswith(_MARK)), None
        )
        if p.returncode != 0 or payload is None:
            failed.append(f"--- worker {pid} (rc={p.returncode}) ---\n"
                          f"{out[-2000:]}\n{err[-2000:]}")
            continue
        results[pid] = json.loads(payload)
    if failed:
        raise SystemExit("\n".join(failed))
    first = results[0]
    for pid, r in results.items():
        if r["selected"] != first["selected"] or r["gains"] != first["gains"]:
            raise SystemExit(
                f"host {pid} disagrees with host 0:\n"
                f"  host 0: {first['selected']} {first['gains']}\n"
                f"  host {pid}: {r['selected']} {r['gains']}"
            )
    merged = dict(
        num_processes=args.num_processes,
        coordinator=coordinator,
        selected=first["selected"],
        gains=first["gains"],
        criterion=first["criterion"],
        hosts=first["io"].get("hosts"),
        per_host_io={
            pid: {k: r["io"][k] for k in ("passes", "blocks_read",
                                          "bytes_read", "state_bytes")}
            for pid, r in sorted(results.items())
        },
        workers={
            pid: dict(device=r["device"], device_name=r["device_name"],
                      launches=r["launches"], seconds=r["seconds"],
                      setup_seconds=r["setup_seconds"],
                      host=r["io"].get("host"), cache=r["io"].get("cache"))
            for pid, r in sorted(results.items())
        },
        seconds=max(r["seconds"] for r in results.values()),
        wall_seconds=wall,
    )
    print(json.dumps(merged))
    return merged


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.num_processes < 1:
        raise SystemExit("--num-processes must be >= 1")
    if args.process_id is None and os.environ.get("REPRO_PROCESS_ID"):
        # Real-cluster launchers configure workers through the environment.
        args.process_id = int(os.environ["REPRO_PROCESS_ID"])
        args.coordinator = args.coordinator or os.environ.get("REPRO_COORDINATOR")
        args.num_processes = int(os.environ.get("REPRO_NUM_PROCESSES", args.num_processes))
    if args.process_id is not None:
        out = _run_worker(args)
        print(_MARK + json.dumps(out), flush=True)
        return out
    return _spawn(args, argv)


if __name__ == "__main__":
    main()

"""Selection-service driver — submit / poll / stats as one JSON report.

    # Demo on the paper's synthetic generator, on the card: the first fit
    # runs the engine, the identical resubmission is a content-addressed
    # cache hit, the distinct fit runs again:
    PYTHONPATH=src python -m repro_torch.launch.serve_select \
        --source corral:20000x64 --select 5 --repeat 2 --distinct-select 3

    # Real files (memmapped .npy pair or CSV), persistent result cache,
    # the plain PyTorch versions on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve_select \
        --source X.npy::y.npy --select 10 --cache-dir /tmp/selcache --device cpu

Each ``--repeat`` beyond the first resubmits the *identical* request
after the first completes — a cache hit with zero engine or I/O passes;
``--distinct-select K`` adds one request with a different ``num_select``
(a genuine second engine run).  The report is a single JSON object:
``jobs`` (lifecycle snapshot + selected ids per submission), ``stats``
(queue depth/capacity/rejections, coalescing and cache hit/miss/eviction
counters, the dict ``SelectionService.stats()`` serves in-process) and the
``device`` the fits ran on.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.criteria import available_criteria
from repro_torch.serve.selection import SelectionService


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", default="corral:20000x64",
                    help="'X.npy::y.npy' | 'data.csv' | 'corral:ROWSxCOLS"
                         "[:SEED]'")
    ap.add_argument("--select", type=int, default=5)
    ap.add_argument("--criterion", default="mid",
                    choices=available_criteria())
    ap.add_argument("--repeat", type=int, default=2,
                    help="total identical submissions (>=1); each after "
                         "the first should be a cache hit")
    ap.add_argument("--distinct-select", type=int, default=0,
                    help="also submit one fit with this num_select "
                         "(0 = off); a distinct job, never a cache hit")
    ap.add_argument("--block-obs", type=int, default=65536)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--queue-cap", type=int, default=32)
    ap.add_argument("--cache-cap", type=int, default=128)
    ap.add_argument("--cache-dir", default=None,
                    help="persist cached results as JSON in this directory")
    ap.add_argument("--device", default="cuda",
                    help="where the fits run (cuda raises without a card)")
    args = ap.parse_args(argv)
    if args.repeat < 1:
        raise SystemExit(f"--repeat must be >= 1, got {args.repeat}")

    knobs = dict(
        criterion=args.criterion, block_obs=args.block_obs,
        prefetch=args.prefetch,
    )
    job_ids = []
    with SelectionService(
        workers=args.workers, queue_capacity=args.queue_cap,
        cache_capacity=args.cache_cap, cache_dir=args.cache_dir,
        device=args.device,
    ) as svc:
        first = svc.submit(args.source, num_select=args.select, **knobs)
        job_ids.append(first)
        svc.result(first)  # wait, so the resubmissions exercise the cache
        for _ in range(args.repeat - 1):
            job_ids.append(
                svc.submit(args.source, num_select=args.select, **knobs)
            )
        if args.distinct_select:
            job_ids.append(
                svc.submit(
                    args.source, num_select=args.distinct_select, **knobs
                )
            )
        jobs = []
        for jid in job_ids:
            result = svc.result(jid)
            info = svc.poll(jid).to_dict()
            info["selected"] = [int(v) for v in result.selected]
            jobs.append(info)
        out = dict(jobs=jobs, stats=svc.stats(), device=svc.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

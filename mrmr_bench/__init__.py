"""The benchmark of ``repro_torch``: timed mRMR fits on one NVIDIA H100.

One run drives one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) through ``MRMRSelector.fit``, prints its metrics and checks
what the fits returned against a plain reference:

    python3 mrmr_bench/run.py --workload tall.mid --seed 7 --seconds 30 --trace 0

Everything a cell needs is found by name: ``configs/<config>.json`` (the
dataset), ``traffic/<traffic>.json`` (the job mix), ``workloads/<cell>.json``
(the comparison's limits) and ``metrics/<metric>.py`` (one reader
a metric).  Nothing here imports JAX or the JAX package.
"""

"""Quickstart on the PyTorch port: distributed mRMR feature selection in
30 lines (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch

Generates the paper's CorrAL-style dataset (Eq. 3: the class is a boolean
function of features 0..7, feature 8 is partially correlated, the rest is
noise), then runs mRMR through the ``MRMRSelector`` front door: once
auto-planned (the paper's §III aspect-ratio rule picks the encoding) and
once per explicit encoding, checking they recover the relevant features.
Also selects with the quotient-form criterion (``criterion="miq"``; from
the CLI: ``python -m repro_torch.launch.select --criterion miq``) and the
class-conditioned pair (``"jmi"``/``"cmim"``) — the greedy objective is
pluggable, orthogonal to the encoding.  Every fit runs on ``--device``
(the card by default, where the contingency, MI and bin-code kernels run);
without a card the default raises.
"""

import argparse
import json
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch import ArraySource, CorralSource, MRMRSelector
from repro_torch.data.synthetic import corral_dataset
from repro_torch.device import resolve_device
from repro_torch.serve import SelectionService

ap = argparse.ArgumentParser(description=__doc__,
                             formatter_class=argparse.RawDescriptionHelpFormatter)
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
dev = str(resolve_device(ap.parse_args().device))

X, y = corral_dataset(20_000, 64, seed=0)
count = torch.cuda.device_count() if dev.startswith("cuda") else 1
print(f"dataset: X{X.shape} y{y.shape}  device: {dev}  devices: {count}")

fs = MRMRSelector(num_select=10, device=dev).fit(X, y)
print(f"{'auto':>12s}: planned encoding = {fs.plan_.encoding!r}")

for encoding in ("conventional", "alternative"):
    fs = MRMRSelector(num_select=10, encoding=encoding, device=dev).fit(X, y)
    sel = fs.selected_.tolist()
    hits = sorted(set(sel) & set(range(9)))
    print(f"{encoding:>12s}: selected {sel}")
    print(f"{'':>12s}  relevant recovered: {hits} ({len(hits)}/9)")

Xt = fs.transform(np.asarray(X))
print(f"transform: {np.asarray(X).shape} -> {Xt.shape}")

# Swap the greedy objective without touching anything else: MIQ divides
# relevance by mean redundancy instead of subtracting it.  The selector's
# read side reports what ran (result_) plus sklearn-style accessors.
fs = MRMRSelector(num_select=10, criterion="miq", device=dev).fit(X, y)
print(f"{'miq':>12s}: selected {fs.selected_.tolist()} "
      f"(criterion={fs.result_.criterion!r}, engine={fs.result_.engine!r})")
print(f"{'':>12s}  support mask sum = {int(fs.get_support().sum())}, "
      f"top-relevance feature = {int(fs.scores_.argmax())}, "
      f"rank of feature 0 = {int(fs.ranking_[0])}")

# Class-conditioned criteria: JMI and CMIM fold the gap
# I(x;x_j|y) - I(x;x_j) (mean vs worst-case) — one fused 3-way count
# per pair feeds both terms, so they cost the same passes as mid.
for criterion in ("jmi", "cmim"):
    fs = MRMRSelector(num_select=10, criterion=criterion, device=dev).fit(X, y)
    hits = sorted(set(fs.selected_.tolist()) & set(range(9)))
    print(f"{criterion:>12s}: selected {fs.selected_.tolist()} "
          f"(relevant recovered: {len(hits)}/9)")

# Out-of-core wide regime: a DataSource streams observation-blocks and a
# wide dataset (obs/feat <= 0.25) plans feature-sharded statistics.
# ``prefetch`` double-buffers placement (the host reads block i+1 while the
# device accumulates block i); selections match the in-memory engines.
wide_src = CorralSource(512, 2048, seed=0)
fs = MRMRSelector(num_select=10, block_obs=128, prefetch=2, device=dev).fit(wide_src)
plan = fs.plan_
print(f"{'streaming':>12s}: encoding={plan.encoding!r} "
      f"obs_axes={plan.obs_axes} feat_axes={plan.feat_axes} "
      f"block_obs={plan.block_obs} prefetch={plan.prefetch}")
print(f"{'':>12s}  selected {fs.selected_.tolist()}")

# Continuous features, exact discrete MI: bins= cuts equal-frequency bin
# edges from ONE streaming quantile-sketch pass, then every block encodes
# to int codes on the fly (on the device, fused ahead of the contingency
# sums).  The float dataset below would otherwise be refused by the MI
# path; with bins= it fits on both the in-memory and streaming engines, and
# the selections agree at every block size because the sketch (and hence
# the edges) is a pure function of the row stream.
rng = np.random.default_rng(0)
yf = rng.integers(0, 2, size=5_000)
Xf = rng.normal(size=(5_000, 32))
Xf[:, :4] += yf[:, None] * np.array([1.6, 1.2, 0.8, 0.5])  # informative

fs_mem = MRMRSelector(num_select=4, bins=16, device=dev).fit(Xf, yf)
fs_str = MRMRSelector(num_select=4, bins=16, block_obs=512, device=dev).fit(ArraySource(Xf, yf))
print(f"{'binned':>12s}: in-memory {fs_mem.selected_.tolist()} == "
      f"streaming {fs_str.selected_.tolist()} (bins={fs_str.plan_.bins})")

# Cutting the L-pass I/O tax: a streamed fit costs 1 relevance pass plus
# num_select-1 redundancy passes over the source.  Three composable knobs
# attack that, with selections bitwise-identical to the plain engine:
#   batch_candidates=q  speculates the top-q candidates' redundancy
#                       vectors per pass -> ~ceil((L-1)/q) redundancy
#                       passes (select=32 at q=8: 31 passes -> 5);
#   spill_dir=          spills each parsed/encoded block on pass 1 and
#                       replays memmapped chunks on passes 2..L (CSV
#                       parse + bin encode paid once per dataset);
#   readahead=          streams the next pass's first blocks while the
#                       device drains the current pass's tail.
# The result reports the measured ledger (result_.io), so the pass math
# is observable, not guessed.
with tempfile.TemporaryDirectory() as spill:
    tall_src = CorralSource(50_000, 64, seed=0)
    plain = MRMRSelector(num_select=10, block_obs=8192, device=dev).fit(tall_src)
    fast = MRMRSelector(
        num_select=10, block_obs=8192, batch_candidates=8,
        spill_dir=spill, readahead=2, device=dev,
    ).fit(tall_src)
    assert plain.selected_.tolist() == fast.selected_.tolist()
    print(f"{'io tax':>12s}: plain passes={plain.result_.io['passes']} "
          f"vs batched+spill+readahead={fast.result_.io['passes']} "
          f"(cache: {fast.result_.io['cache']})")

# Selection-as-a-service: fits run as managed jobs behind a bounded work
# queue, with a content-addressed result cache (source fingerprint x
# score x criterion x num_select) and idempotency-key coalescing — the
# identical resubmission below is a cache hit with zero engine or I/O
# passes, and a stampede of identical concurrent submits runs once.
# (CLI: python -m repro_torch.launch.serve_select --repeat 2 --distinct-select 3)
with SelectionService(workers=2, device=dev) as svc:
    job = svc.submit(CorralSource(20_000, 64, seed=0), num_select=10)
    result = svc.result(job)  # blocks until DONE; raises on FAILED
    again = svc.submit(CorralSource(20_000, 64, seed=0), num_select=10)
    info = svc.poll(again)
    print(f"{'service':>12s}: selected {[int(v) for v in result.selected]}")
    print(f"{'':>12s}  resubmission cache_hit={info.cache_hit} "
          f"cache={svc.stats()['cache']}")

# Multi-host map-reduce: the same streaming fit across N torch.distributed
# (gloo) processes, each reading ONLY its shard of the data (§III applied
# to hosts: tall -> row ranges, wide -> column ranges, both-large -> a 2-D
# host grid).  The per-pass reduce is an explicit sum of exact integer
# statistics, so every host commits the identical selection — the launcher
# checks every host against host 0.  In a worker you would call
# init_multihost() then MRMRSelector(..., hosts="auto"); here we drive the
# spawn-mode launcher, which stands up a loopback 2-process group, both
# workers on this device.
# (Real cluster: one invocation per machine with --coordinator/--process-id.)
proc = subprocess.run(
    [sys.executable, "-m", "repro_torch.launch.select_multihost",
     "--num-processes", "2", "--rows", "6000", "--cols", "24",
     "--select", "4", "--block-obs", "1500", "--device", dev.split(":")[0]],
    capture_output=True, text=True, check=True,
)
mh = json.loads(proc.stdout.splitlines()[-1])
agg = mh["hosts"]["aggregate"]["bytes_read"]
shares = [round(h["bytes_read"] / agg, 2) for h in mh["hosts"]["per_host"]]
print(f"{'multihost':>12s}: grid={mh['hosts']['grid']} "
      f"selected {mh['selected']}")
print(f"{'':>12s}  per-host share of bytes read: {shares}")

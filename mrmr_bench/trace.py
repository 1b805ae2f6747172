"""The traced window, read from ``torch.profiler``'s Chrome trace.

The traced window runs from the first fit span's start to the last one's
end (the harness wraps every fit in a span named ``fit:<cell>:target<k>``
and traces the window's last ``TRACE_SECONDS``).  Within it: the fits, the
seconds in which some kernel, copy or fill ran on the device, each
kernel's device seconds by name, and the idle gaps between device work,
each put down to the innermost host operation running at its middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json

FIT_SPAN = "fit:"
TRACE_SECONDS = 10.0  # the window's last seconds that a traced run profiles
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
_TOP = 10
_NAME = 160  # characters of an operation's name kept in the breakdown


@dataclasses.dataclass
class Summary:
    fits: int  # fit spans in the traced window
    window_s: float
    busy_s: float
    device_s: dict  # device operation name -> seconds inside the window
    gaps_s: dict  # host operation name -> idle seconds while it ran

    def kernel_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(s for name, s in self.device_s.items() if match(name))

    def breakdown(self) -> dict:
        """The ``_TOP`` device operations by time, and idle gaps by host
        operation, as the result line's ``breakdown``."""
        return {"device_ops": _top(self.device_s), "idle_gaps": _top(self.gaps_s)}


def _top(seconds: dict) -> list:
    ranked = sorted(seconds.items(), key=lambda e: -e[1])[:_TOP]
    return [[name[:_NAME], s] for name, s in ranked]


def _merge(spans: list) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host: list, times: list) -> list:
    """For each of the sorted ``times``, the name of the shortest host
    operation that holds it (``host``: (start, end, name), sorted)."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        best = min(active, key=lambda h: h[1] - h[0], default=None)
        name = best[2] if best else "(no host operation)"
        # The fit spans of all targets count as one host operation.
        out.append(name.split(":target")[0] if name.startswith(FIT_SPAN) else name)
    return out


def summarize(path: str) -> Summary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    fits, dev, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if cat == "user_annotation" and name.startswith(FIT_SPAN):
            fits.append(span)
        if cat in DEVICE_CATS:
            dev.append((*span, name))
        elif cat in HOST_CATS:
            host.append((*span, name))
    if not fits:
        return Summary(0, 0.0, 0.0, {}, {})
    w0, w1 = min(a for a, _ in fits), max(b for _, b in fits)
    device_s = collections.Counter()
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            device_s[name] += (b - a) * 1e-6
            clipped.append((a, b))
    busy = _merge(clipped)
    host.sort()
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps_s = collections.Counter()
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) / 2 for a, b in gaps])):
        gaps_s[name] += (b - a) * 1e-6
    return Summary(
        fits=len(fits),
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=dict(device_s),
        gaps_s=dict(gaps_s),
    )

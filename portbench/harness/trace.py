"""The traced part of a ``--trace 1`` run: ``trace_calls`` calls under
``torch.profiler`` (CPU and CUDA activity), reduced to what the per-layer
metrics and the ``breakdown`` read.

- ``kernels``: each device activity's name (a kernel, a copy, a memset)
  with its summed device seconds and count;
- ``busy_s``: the union of the device intervals inside the traced window,
  ``window_s`` its length (the calls back to back, each ending in a
  synchronize, from the first call's span to the last's); the device's
  idle share is ``1 - busy_s / window_s`` (``bench_torch.idle_share``'s
  reading, with overlapping activities counted once);
- ``gaps``: the device's idle time inside the window, by what the host was
  doing there: the innermost profiler op (``cpu_op``, ``user_annotation``)
  over the gap's middle, or, where the host ran no op, the op it ran last.

The profiler's Chrome trace goes to ``build/portbench/trace.json`` inside
the checkout and is deleted once read.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

from .spec import ROOT

__all__ = ["Trace", "profile", "reduce_events", "SPAN"]

SPAN = "portbench.call"  # the harness's span around each traced call
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@dataclass
class Trace:
    calls: int
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> [seconds, count]
    gaps: dict = field(default_factory=dict)  # host activity -> seconds
    first: int = 0  # the first traced call's index

    def kernel_s(self, match) -> float:
        """Summed device seconds of the activities whose name ``match``
        (a compiled regex) finds."""
        return sum(s for name, (s, _n) in self.kernels.items()
                   if match.search(name))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def reduce_events(events, calls: int) -> Trace:
    """A :class:`Trace` from Chrome-trace events (``ts``/``dur`` in us);
    the window runs from the first of the harness's spans to the end of
    the last."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == SPAN]
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    tr = Trace(calls=calls, window_s=(hi - lo) * 1e-6)
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            k = tr.kernels.setdefault(e["name"], [0.0, 0])
            k[0] += e["dur"] * 1e-6
            k[1] += 1
            a, b = max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])
            if b > a:
                dev.append((a, b))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    tr.busy_s = sum(b - a for a, b in merged) * 1e-6
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("name") != SPAN), key=lambda h: h[0])
    starts = [h[0] for h in host]
    ends = sorted((h[1], h[2]) for h in host)
    end_ts = [h[0] for h in ends]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [h for h in host[: bisect.bisect_right(starts, mid)]
                 if h[1] >= mid]
        if inner:
            label = min(inner, key=lambda h: h[1] - h[0])[2]
        else:
            j = bisect.bisect_right(end_ts, mid) - 1
            label = ("host, no op, after " + ends[j][1]) if j >= 0 else \
                "host, no op"
        tr.gaps[label] = tr.gaps.get(label, 0.0) + (b - a) * 1e-6
    return tr


def profile(call, first: int, n: int) -> Trace:
    """Make calls ``first .. first + n - 1`` under the profiler and reduce
    the trace."""
    import torch
    from torch import profiler as tp

    out = ROOT / "build" / "portbench" / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            with tp.record_function(SPAN):
                call(i)
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out))
    try:
        with open(out) as f:
            events = json.load(f)["traceEvents"]
    finally:
        out.unlink()
    tr = reduce_events(events, n)
    tr.first = first
    if tr.busy_s <= 0:
        raise RuntimeError("the profiler saw no device activity")
    return tr

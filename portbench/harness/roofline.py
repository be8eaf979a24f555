"""Rooflines and the idle share, read from a run's trace.

A kernel's share of its roofline is the least time the card could take
for the bytes its work needs, at the published 3.35 TB/s of one H100 SXM's
HBM (NVIDIA's data sheet; the card's power limit is in the line's
``device``), over the kernel's device time in the trace.  The bytes are
``chip_smoke.py`` phase 4's: each input byte read once and each output byte
written once, never what a kernel reads again; a walk's reads are counted by
the tokens it visits, which the plain reference's parse
(:func:`portbench.reference.tamp_plain.count_tokens`) counts in the traced
calls' streams.  The integer-operation bound is not counted."""

from __future__ import annotations

import re

from portbench.reference import check, tamp_plain

__all__ = ["HBM_BYTES_PER_S", "share", "idle_share", "shape_bytes",
           "stream_work"]

HBM_BYTES_PER_S = 3.35e12


def shape_bytes(run) -> dict:
    """``S`` shards of ``L`` bytes, the window ``W``, and the mean raw and
    container bytes of the window's calls."""
    ok = [c for c in run.calls if c.ok]
    return dict(S=run.shards, L=run.shard_bytes,
                W=1 << int(run.config["window"]),
                raw=sum(c.raw_bytes for c in ok) / max(1, len(ok)),
                packed=sum(c.packed_bytes for c in ok) / max(1, len(ok)))


def stream_work(run):
    """The mean over the traced calls of the tokens, the matches and the
    stream bytes of the container each call made or read (the entry
    point's ``containers``, a call cycling the pool), or None without a
    trace or with a container missing.  Counted once a run, the streams
    spread over processes."""
    if run.trace is None:
        return None
    if "stream_work" not in run.state:
        blobs = run.entry.containers(run)
        work = None
        if blobs and all(b is not None for b in blobs):
            streams = [tamp_plain.parse_frame(b)[3] for b in blobs]
            counts = iter(check._map(tamp_plain.count_tokens,
                                     [s for ss in streams for s in ss]))
            work = []
            for ss in streams:
                c = [next(counts) for _ in ss]
                work.append(dict(tokens=sum(t for t, _m in c),
                                 matches=sum(m for _t, m in c),
                                 bodies=sum(len(s) for s in ss)))
        run.state["stream_work"] = work
    work = run.state["stream_work"]
    if work is None:
        return None
    picked = [work[(run.trace.first + k) % len(work)]
              for k in range(run.trace.calls)]
    return {k: sum(w[k] for w in picked) / len(picked) for k in picked[0]}


def share(run, pattern: str, bytes_per_call: float):
    """% of the roofline of the kernels whose names ``pattern`` finds, or
    None where the trace holds none of them."""
    if run.trace is None:
        return None
    t = run.trace.kernel_s(re.compile(pattern))
    if t <= 0:
        return None
    return 100.0 * bytes_per_call * run.trace.calls / HBM_BYTES_PER_S / t


def idle_share(run):
    """% of the traced window with no device activity."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

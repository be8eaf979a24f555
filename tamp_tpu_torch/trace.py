"""Spans and counters inside the port, recorded while a profiler runs.

Tracing is on exactly while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``, a module global every
thread reads): profile a call and its spans and counters are kept; outside
a profile :func:`span` returns a shared no-op context after one flag test
and :func:`count` adds nothing.  There is no other switch.

A span records its name, its start and end (``time.perf_counter_ns``), its
thread, its parent (a thread-local stack) and the id of its call: a span
opened with no span open on its thread opens a call (the container API's
``tamp.compress_sharded``, ``tamp.decompress_sharded`` and
``tamp.decompress_sharded_device``, each the whole call: :func:`spanned`),
and every span under it shares the call's id.  Work handed to a thread pool is wrapped by :func:`bind` before
it is submitted, so a worker's spans carry the call and their parent
across the thread boundary.  A span on the call's own thread is also
entered as ``torch.profiler.record_function(name)``, so it lands in the
profiler's timeline beside the kernels and copies; a worker's spans do not
(the profiler keeps the annotations of its own thread only) and are kept
here alone.  A span given a CUDA ``device`` records a pair of timing
events on the current stream at entry and exit; their elapsed time is read
by :func:`snapshot`, never inside the call.

Counters are integer adds under the same flag.  Spans and counters stay in
memory until :func:`reset`.  :func:`snapshot` also reports the kernel
wrappers' own launch counters (``fn.launches``), which count whether
tracing is on or not.
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "Snapshot", "enabled", "span", "spanned", "count",
           "bind", "snapshot", "reset", "LAUNCHES"]

# The kernel wrappers that count their launches: (module, function).
LAUNCHES = (
    ("ops.match_ext", "ext_tables"), ("ops.match_ext", "ext_tables_probe"),
    ("ops.match_v1", "v1_tables"),
    ("ops.encode_commit", "commit_fields"),
    ("ops.encode_commit", "commit_v1_lazy"),
    ("ops.greedy_predict", "greedy_predict_batch"),
    ("ops.decode_commit", "commit_decode"),
    ("ops.token_chase", "token_table_chase"),
    ("ops.decode_wavefront", "trunc_deficits"),
    ("ops.decode_wavefront", "parse_words"),
    ("ops.decode_serial", "serial_decode"),
    ("ops.opt_parse", "opt_v1_choice"),
    ("ops.opt_parse_ext", "opt_ext_choice"),
)


class Span(NamedTuple):
    """One finished span.  ``device_ms``: the CUDA events' elapsed time of
    a span given a CUDA device, else None; ``attrs``: its integer
    attributes (bytes, shards)."""

    name: str
    call: int
    id: int
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    device_ms: float | None
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Snapshot(NamedTuple):
    """What :func:`snapshot` returns: the finished spans in the order they
    ended, the counters, and each kernel wrapper's launch count
    (``"<module>.<function>"``: ``fn.launches``, of the wrappers whose
    module is loaded)."""

    spans: tuple
    counters: dict
    launches: dict


_lock = threading.Lock()
_local = threading.local()  # .top: (call, span id, the call's thread)
_ids = itertools.count(1)
_spans: list = []  # [Span, (start event, end event) | None]
_counters: dict = {}


def enabled() -> bool:
    """True while a ``torch.profiler`` session is active."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span of a call made with tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "device", "attrs", "prev", "top", "thread", "start",
                 "rf", "events")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        self.thread = me = threading.get_ident()
        self.prev = prev = getattr(_local, "top", None)
        sid = next(_ids)
        if prev is None:
            self.top = (sid, sid, me)  # a call of its own
        else:
            self.top = (prev[0], sid, prev[2])
        _local.top = self.top
        self.rf = None
        if self.top[2] == me:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.events = None
        if self.device is not None and \
                torch.device(self.device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _local.top = self.prev
        call, sid, _ = self.top
        rec = Span(self.name, call, sid, None if self.prev is None
                   else self.prev[1], self.thread, self.start, end, None,
                   self.attrs)
        with _lock:
            _spans.append([rec, self.events])
        return False


def span(name: str, *, device=None, **attrs):
    """A context that records the span ``name`` with the integer
    ``attrs`` while tracing is on (a shared no-op otherwise).  ``device``:
    the device the span's work runs on; on a CUDA one the span
    also records the device time between its entry and exit."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, device, attrs)


def spanned(name: str):
    """Decorate a function so that each call is the span ``name`` while
    tracing is on, its locals' release included."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name, None, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def bind(fn):
    """``fn`` to be run in another thread as a child of the span open on
    this one (``fn`` itself when none is open)."""
    top = getattr(_local, "top", None)
    if top is None:
        return fn

    def bound(*args, **kwargs):
        prev = getattr(_local, "top", None)
        _local.top = top
        try:
            return fn(*args, **kwargs)
        finally:
            _local.top = prev

    return bound


def _launches() -> dict:
    out = {}
    pkg = __name__.rsplit(".", 1)[0]
    for mod, fn in LAUNCHES:
        m = sys.modules.get(f"{pkg}.{mod}")
        if m is not None:
            out[f"{mod[4:]}.{fn}"] = int(getattr(m, fn).launches)
    return out


def snapshot() -> Snapshot:
    """The spans and counters recorded since the last :func:`reset`; reads
    each device span's events once (waiting for them), and leaves the
    record as it was."""
    with _lock:
        recs = list(_spans)
        counters = dict(_counters)
    spans = []
    for rec in recs:
        s, events = rec
        if events is not None:
            events[1].synchronize()
            s = rec[0] = s._replace(device_ms=events[0].elapsed_time(
                events[1]))
            rec[1] = None
        spans.append(s)
    return Snapshot(tuple(spans), counters, _launches())


def reset() -> None:
    """Drop every recorded span and counter (the launch counters are the
    wrappers' own and stay)."""
    with _lock:
        _spans.clear()
        _counters.clear()

"""The readers of the program's spans and counters, and of the trace's
named idle gaps, on a made-up run: a hand-made ``Trace`` and a hand-made
snapshot of ``tamp_tpu_torch.trace`` (the spans themselves are tested in
the program's tests)."""

from __future__ import annotations

import sys

import pytest

from portbench.harness import spec, trace
from portbench.harness.main import Run

tt = pytest.importorskip("tamp_tpu_torch.trace")

MS = 1_000_000  # ns


def _span(name, ms, device_ms=None, call=1):
    return tt.Span(name, call, 0, None, 0, 0, int(ms * MS), device_ms, {})


SNAP = tt.Snapshot(
    spans=(
        _span("tamp.encode.commit.shard", 30.0),
        _span("tamp.encode.commit.shard", 50.0),
        _span("tamp.encode.commit", 60.0),
        _span("tamp.encode.tail", 12.0),
        _span("tamp.encode.tail", 8.0, call=2),
        _span("tamp.decode.copy", 3.0),
        _span("tamp.decode.copy", 5.0, call=2),
        _span("tamp.decode.parse", 40.0, device_ms=35.0),
        _span("tamp.decode.parse", 40.0, device_ms=37.0, call=2),
    ),
    counters={"encode.raw_bytes": 4 << 20, "encode.pull_bytes": 1 << 20,
              "commit.lookups": 200, "commit.table_hits": 50,
              "commit.hole_searches": 100, "commit.seeded_searches": 40,
              "commit.full_searches": 10},
    launches={"greedy_predict.greedy_predict_batch": 2})
EMPTY = tt.Snapshot((), {}, {})

WANT = {
    "commit_ms_per_mib": 80.0 / 4,
    "b7_hit_share": 25.0,
    "pull_bytes_per_byte": 0.25,
    "ring_tail_ms": 10.0,
    "x2_host_copy_ms": 4.0,
    "parse_device_ms": 36.0,
}


def _run(calls=2):
    c = spec.load_cell("ext-w10.encode.16x1m")
    run = Run(cell=c, seed=1, device="cuda", shard_bytes=1 << 20)
    run.trace = trace.Trace(calls=calls, window_s=1.0, busy_s=0.2, gaps={
        "tamp.encode.commit": 0.5, "tamp.encode.pull": 0.2,
        "host, no op, after aten::resolve_neg": 0.06, "host, no op": 0.24})
    return run


def _reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            f"t_{name.replace('.', '_')}").read


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_readers(monkeypatch, name):
    read = _reader(name)
    monkeypatch.setattr(tt, "snapshot", lambda: SNAP)
    assert read(_run()) == pytest.approx(WANT[name])
    monkeypatch.setattr(tt, "snapshot", lambda: EMPTY)
    assert read(_run()) is None  # nothing recorded
    monkeypatch.setattr(tt, "snapshot", lambda: SNAP)
    run = _run()
    run.trace = None
    assert read(run) is None  # no traced run (a rehearsal)
    monkeypatch.setitem(sys.modules, "tamp_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["tamp_tpu_torch"], "trace")
    assert read(_run()) is None  # a program without the module


def test_hit_share_without_lookups(monkeypatch):
    read = _reader("b7_hit_share")
    counters = {**SNAP.counters, "commit.lookups": 0,
                "commit.table_hits": 0}
    monkeypatch.setattr(tt, "snapshot",
                        lambda: tt.Snapshot(SNAP.spans, counters, {}))
    assert read(_run()) is None


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_idle_named_share(side):
    read = _reader(f"idle_named_share.{side}")
    assert read(_run()) == pytest.approx(70.0)  # 0.7 of 1.0 s idle
    run = _run()
    run.trace.gaps = {}
    assert read(run) is None
    run.trace = None
    assert read(run) is None
    run = _run()
    run.trace = trace.reduce_events([
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "tamp.compress_sharded",
         "ts": 6, "dur": 89},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 10}],
        calls=1)
    # a gap is labelled at its middle: 0-10 by no op, 20-100 by the span
    assert read(run) == pytest.approx(100 * 80 / 90)

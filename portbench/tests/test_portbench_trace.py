"""The trace's reduction and the per-layer readers on a made-up trace
(the profiler's own output exists only on the card)."""

from __future__ import annotations

import json
import types

import pytest

from portbench.harness import roofline, spec, trace
from portbench.harness.main import Call, Run
from portbench.reference import tamp_plain as T

US = 1.0


def _events():
    span = lambda ts, dur: {"ph": "X", "cat": "user_annotation",  # noqa
                            "name": trace.SPAN, "ts": ts, "dur": dur}
    op = lambda name, ts, dur, cat="cpu_op": {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [
        span(0, 1000), span(1000, 1000),
        op("aten::copy_", 0, 100), op("compress", 100, 50),
        op("void tables_kernel<false, false>(unsigned char const*)", 50,
           200, "kernel"),
        op("Memcpy DtoH (Device -> Pageable)", 300, 100, "gpu_memcpy"),
        op("fields_pack_kernel", 350, 100, "kernel"),  # overlaps the copy
        op("serial_decode_kernel", 1500, 300, "kernel"),
        op("aten::empty", 1200, 10),
        {"ph": "M", "name": "process_name"},
    ]


def test_reduce_events():
    tr = trace.reduce_events(_events(), calls=2)
    assert tr.window_s == pytest.approx(2000e-6)
    # 50-250, 300-450 (a copy and a kernel overlapping), 1500-1800
    assert tr.busy_s == pytest.approx(650e-6)
    assert tr.kernels["serial_decode_kernel"] == [pytest.approx(3e-4), 1]
    gaps = tr.gaps
    assert gaps["aten::copy_"] == pytest.approx(50e-6)  # 0-50
    assert gaps["host, no op, after compress"] == pytest.approx(
        50e-6 + 1050e-6)  # 250-300 and 450-1500
    assert gaps["host, no op, after aten::empty"] == pytest.approx(200e-6)
    assert sum(gaps.values()) + tr.busy_s == pytest.approx(tr.window_s)
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "serial_decode_kernel"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_no_span_no_trace():
    with pytest.raises(RuntimeError):
        trace.reduce_events([e for e in _events()
                             if e.get("name") != trace.SPAN], calls=2)


def _container(data: bytes, shard: int) -> bytes:
    """A TTPU v2 container of ``data`` made by the reference encoder."""
    streams = [T.encode(data[i:i + shard])
               for i in range(0, len(data), shard)]
    head = (b"TTPU" + bytes([2, 0]) + len(streams).to_bytes(4, "little")
            + len(data).to_bytes(8, "little") + shard.to_bytes(8, "little"))
    return head + b"".join(len(s).to_bytes(4, "little") for s in streams) \
        + b"".join(streams)


BLOBS = [_container(b"abcabcabd" * 300 + bytes(range(200)), 1024),
         _container(b"xyz" * 700 + b"q" * 300, 1024)]


def _run(cell):
    c = spec.load_cell(cell)
    run = Run(cell=c, seed=1, device="cuda", shard_bytes=1 << 20)
    run.inputs = [b""] * 2
    run.entry = types.SimpleNamespace(containers=lambda run: BLOBS)
    run.calls = [Call(0.0, 0.1, 16 << 20, 10 << 20, True),
                 Call(0.1, 0.3, 16 << 20, 10 << 20, True)]
    run.window_s = 0.3
    run.trace = trace.reduce_events(_events(), calls=2)
    return run


@pytest.mark.parametrize("name", ["b5_roofline", "b3_roofline",
                                  "x2_roofline", "idle_share.encode"])
def test_readers_on_a_trace(name):
    run = _run("v1-w10.encode.64x1m")
    mod = spec.load_module(spec.BENCH / "metrics" / f"{name}.py", "t_m")
    got = mod.read(run)
    assert got is not None and 0 < got


def test_a_roofline_with_nothing_to_read_is_silent():
    run = _run("ext-w10.encode.16x1m")
    for name in ("b7_roofline", "b4_roofline"):
        mod = spec.load_module(spec.BENCH / "metrics" / f"{name}.py", "t_m")
        assert mod.read(run) is None
    run.trace = None
    assert roofline.idle_share(run) is None


def test_b5_bytes_from_the_shapes():
    run = _run("v1-w10.encode.64x1m")
    mod = spec.load_module(spec.BENCH / "metrics" / "b5_roofline.py", "t_m")
    S, L = 64, 1 << 20
    t = 200e-6
    want = 100 * (9 * S * L + 1024 + 4 * S) * 2 / roofline.HBM_BYTES_PER_S / t
    assert mod.read(run) == pytest.approx(want)


def test_end_to_end_readers():
    run = _run("ext-w10.decode.16x1m")
    read = {n: spec.load_module(spec.BENCH / "metrics" / f"{n}.py",
                                "t_m").read(run)
            for n in ("decode_mb_s", "decode_p95_ms", "ratio",
                      "encode_mb_s.host")}
    assert read["decode_mb_s"] == pytest.approx(2 * (16 << 20) / 0.3 / 1e6)
    assert 100 < read["decode_p95_ms"] <= 200
    assert read["ratio"] == pytest.approx(10 / 16)
    assert read["encode_mb_s.host"] == pytest.approx(read["decode_mb_s"])
    json.dumps(read)


@pytest.mark.parametrize("name,kernel", [
    ("b7_roofline", "predict_pack_kernel"),
    ("b3_roofline", "fields_pack_kernel"),
    ("b4_roofline", "commit_decode_kernel")])
def test_walk_bytes_from_the_streams_tokens(name, kernel):
    """The walks' bytes count the traced calls' tokens (phase 4's
    formulas): the traced calls 1 and 2 cycle the pool's two containers."""
    run = _run("ext-w10.encode.16x1m")
    run.trace.kernels = {kernel: [1e-4, 1]}
    run.trace.first = 1
    work = [[T.count_tokens(s) for s in T.parse_frame(b)[3]] for b in BLOBS]
    tokens = sum(t for c in work for t, _m in c) / 2
    matches = sum(m for c in work for _t, m in c) / 2
    bodies = sum(len(s) for b in BLOBS for s in T.parse_frame(b)[3]) / 2
    S, L, raw = 16, 1 << 20, 16 << 20
    want = {"b7_roofline": 4 * tokens + S * L / 8 + 4 * matches + 36 * S,
            "b3_roofline": 8 * tokens + bodies + 68 * S,
            "b4_roofline": 4 * tokens + 2 * 1024 + raw + 8 * S}[name]
    mod = spec.load_module(spec.BENCH / "metrics" / f"{name}.py", "t_m")
    assert mod.read(run) == pytest.approx(
        100 * want * 2 / roofline.HBM_BYTES_PER_S / 1e-4)
    assert 0 < matches < tokens

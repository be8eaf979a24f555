"""The port's spans and counters (tamp_tpu_torch.trace) on the CPU.

Tracing is on exactly while a ``torch.profiler`` session runs.  Each
container entry point is called twice under the profiler and once without
it: the spans each call records, their parents and call ids, the profiler
annotations of the caller's thread, the counters, and that the outputs do
not change by a byte."""

import importlib.util
import json
import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import profiler as tp

from tamp_tpu_torch import trace
from tamp_tpu_torch.engine import pipeline, pipeline_ext
from tamp_tpu_torch.engine.greedy import COMMIT_STATS
from tamp_tpu_torch.engine.pipeline_ext import greedy_commits
from tamp_tpu_torch.parallel import shard

ROOT = Path(__file__).resolve().parent.parent
SHARD = 4096
SHARDS = 3


def _corpus(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)))
             for _ in range(160)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 160, n))
    return text[: n // 2] + b"=" * 300 + text[n // 2 : n]


DATA = _corpus(SHARDS * SHARD, 7)[: SHARDS * SHARD]
CASES = {
    "ext": lambda d: shard.compress_sharded(d, shard_size=SHARD,
                                            device="cpu"),
    "v1": lambda d: shard.compress_sharded(d, shard_size=SHARD,
                                           extended=False, device="cpu"),
    "planned": lambda d: shard.compress_sharded(
        d, shard_size=SHARD, engine="device-commit", device="cpu"),
    "x2": lambda b: shard.decompress_sharded(b, workers=2, device="cpu"),
    "device": lambda b: shard.decompress_sharded_device(b, device="cpu"),
}
CONTAINER = None

# Spans a call records: once a call, once a shard, and the decodes' once a
# payload group (one group here: every shard shares one header byte and
# the batches hold all of them).
ONCE = {
    "ext": ["tamp.compress_sharded", "tamp.encode.split", "tamp.encode.prep",
            "tamp.encode.h2d", "tamp.encode.device", "tamp.encode.pull",
            "tamp.encode.commit", "tamp.frame.pack"],
    "v1": ["tamp.compress_sharded", "tamp.encode.split", "tamp.encode.prep",
           "tamp.encode.history", "tamp.encode.h2d", "tamp.encode.device",
           "tamp.encode.pull", "tamp.encode.tail", "tamp.frame.pack"],
    # the planner's two spans: the region planes and sentinel fill before
    # B1, plan_fields_ext after it
    "planned": ["tamp.compress_sharded", "tamp.encode.split",
                "tamp.encode.prep", "tamp.encode.h2d", "tamp.encode.device",
                "tamp.encode.plan", "tamp.encode.plan", "tamp.encode.pull",
                "tamp.encode.tail", "tamp.frame.pack"],
    "x2": ["tamp.decompress_sharded", "tamp.frame.parse", "tamp.decode.h2d",
           "tamp.decode.kernel", "tamp.decode.d2h"],
    "device": ["tamp.decompress_sharded_device", "tamp.frame.parse",
               "tamp.decode.h2d", "tamp.decode.parse", "tamp.decode.kernel",
               "tamp.decode.d2h"],
}
PER_SHARD = {"ext": ["tamp.encode.commit.shard", "tamp.encode.tables"],
             "planned": ["tamp.encode.prep.shard"]}
# the zeroed output, each group's bytes, each batch's slice copies
COPIES = {"x2": 3, "device": 2}


def _input(case: str):
    global CONTAINER
    if case in ("ext", "v1", "planned"):
        return DATA
    if CONTAINER is None:
        CONTAINER = CASES["ext"](DATA)
    return CONTAINER


@pytest.fixture(scope="module", params=list(CASES))
def traced(request):
    """(case, outputs without the profiler, the snapshot taken then,
    outputs of two calls under it, its snapshot, its Chrome trace
    events)."""
    case = request.param
    fn, x = CASES[case], _input(case)
    trace.reset()
    off = fn(x)
    snap_off = trace.snapshot()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        on = [fn(x), fn(x)]
    snap = trace.snapshot()
    trace.reset()
    path = ROOT / "build" / "test_torch_trace" / f"{case}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    return case, off, snap_off, on, snap, events


def test_off_records_nothing_and_on_changes_no_byte(traced):
    case, off, snap_off, on, snap, _ = traced
    assert snap_off.spans == () and snap_off.counters == {}
    assert not trace.enabled()
    assert on == [off, off]
    want = DATA if case in ("x2", "device") else None
    if want is not None:
        assert bytes(off) == want
    assert snap.spans and snap.counters


def test_each_span_once_a_call_a_shard_or_a_group(traced):
    case, _, _, _, snap, _ = traced
    calls = {s.call for s in snap.spans}
    assert len(calls) == 2
    for call in calls:
        got = Counter(s.name for s in snap.spans if s.call == call)
        want = Counter(ONCE[case])
        for name in PER_SHARD.get(case, ()):
            want[name] = SHARDS
        if case in COPIES:
            want["tamp.decode.copy"] = COPIES[case]
        assert got == want


def test_spans_carry_their_parent_and_their_call(traced):
    case, _, _, _, snap, _ = traced
    by_id = {s.id: s for s in snap.spans}
    roots = [s for s in snap.spans if s.parent is None]
    assert [s.name for s in roots] == [ONCE[case][0]] * 2
    assert all(s.call == s.id for s in roots)
    for s in snap.spans:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert s.call == parent.call
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        want = {"tamp.encode.tables": "tamp.encode.commit.shard",
                "tamp.encode.commit.shard": "tamp.encode.commit",
                "tamp.encode.history": "tamp.encode.prep",
                "tamp.encode.prep.shard": "tamp.encode.prep",
                "tamp.encode.plan": "tamp.encode.device"}
        assert parent.name == want.get(s.name, ONCE[case][0]), s
    assert all(s.device_ms is None for s in snap.spans)  # no CUDA events
    shards = [s for s in snap.spans if s.name in ("tamp.encode.commit.shard",
                                                  "tamp.encode.prep.shard")]
    assert sorted(s.attrs["bytes"] for s in shards) == [SHARD] * len(shards)


def test_caller_thread_spans_are_profiler_annotations(traced):
    case, _, _, _, snap, events = traced
    roots = {s.id: s.thread for s in snap.spans if s.parent is None}
    on_caller = Counter(s.name for s in snap.spans
                        if s.thread == roots[s.call])
    in_trace = Counter(e["name"] for e in events
                       if e.get("ph") == "X"
                       and e.get("cat") == "user_annotation"
                       and e["name"].startswith("tamp."))
    assert in_trace == on_caller
    # the committer's workers: kept by the module, not by the profiler
    worker = {"ext": "tamp.encode.commit.shard",
              "planned": "tamp.encode.prep.shard"}.get(case)
    if worker:
        assert worker not in in_trace
        assert all(s.thread != roots[s.call] for s in snap.spans
                   if s.name == worker)


def test_counters_of_a_call(traced):
    case, _, _, _, snap, _ = traced
    c = snap.counters
    if case in ("ext", "v1", "planned"):
        assert c["encode.raw_bytes"] == 2 * len(DATA)
        assert c["encode.h2d_bytes"] > c["encode.raw_bytes"]
        assert 0 < c["encode.pull_bytes"]
    else:
        # a bytes a shard, then the output's copy of them, each call
        assert c["decode.copy_bytes"] == 2 * 2 * len(DATA)
        assert c["decode.d2h_bytes"] >= 2 * len(DATA)
        assert c["decode.h2d_bytes"] > 0
    if case == "planned":
        # the 300-byte run of "=": a forced region of 299 input bytes, of
        # which the model keeps 8 + 8 (two chunks)
        assert c["encode.planned_bytes"] == 2 * 299
        assert c["encode.model_bytes"] == 2 * (len(DATA) - 299 + 16)
    else:
        assert "encode.planned_bytes" not in c
    if case == "ext":
        parts = [c[name] for name in COMMIT_STATS[1:]]
        assert c["commit.lookups"] == sum(parts) > 0
    else:
        assert not any(name in c for name in COMMIT_STATS)


@pytest.mark.parametrize("case,pull", [("ext", "sparse"), ("ext", "dense"),
                                       ("v1", None)])
def test_pull_bytes_are_the_pulled_arrays(monkeypatch, case, pull):
    """``encode.pull_bytes`` is the nbytes of what the encode copies off
    the card: B7's bitmap and the entry words, the dense plane, or v1's
    state rows and body block."""
    pulled = []
    real_cpu = torch.Tensor.cpu
    # the copies the engine and its pull helpers make (the plain versions
    # of the kernels make their own)
    pulls = {"encode_ext_device_greedy", "pull_sparse",
             "encode_v1_device_commit", "pull_body_bytes"}

    def cpu(t, *a, **k):
        out = real_cpu(t, *a, **k)
        if sys._getframe(1).f_code.co_name in pulls:
            pulled.append(out.numpy().nbytes)
        return out

    shards = [DATA[i : i + SHARD] for i in range(0, len(DATA), SHARD)]
    trace.reset()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
        if case == "ext":
            got = pipeline_ext.encode_ext_device_greedy(shards, pull=pull,
                                                        device="cpu")
        else:
            got = pipeline.encode_v1_device_commit(shards, device="cpu")
        monkeypatch.undo()
    c = trace.snapshot().counters
    trace.reset()
    assert len(pulled) == (1 if pull == "dense" else 2)
    assert c["encode.pull_bytes"] == sum(pulled)
    assert len(got) == SHARDS


def _b7_hit_share():
    path = ROOT / "portbench" / "metrics" / "b7_hit_share.py"
    spec = importlib.util.spec_from_file_location("t_b7_hit_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_no_tables_no_lookups():
    """The table-less committer looks nothing up: every count is 0, and
    the hit share has nothing to read."""
    datas = [np.frombuffer(DATA[i : i + SHARD], np.uint8)
             for i in range(0, len(DATA), SHARD)]
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=1))
    trace.reset()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        got = greedy_commits(datas, lambda i: None)
        assert _b7_hit_share()(run) is None
    c = trace.snapshot().counters
    trace.reset()
    assert got == greedy_commits(datas, lambda i: None)
    assert all(c.get(name, 0) == 0 for name in COMMIT_STATS)
    assert _b7_hit_share()(run) is None


def test_bind_and_reset():
    """A worker's span takes the caller's call and parent only through
    :func:`trace.bind`; :func:`trace.reset` drops spans and counters but
    not the wrappers' launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    def work():
        with trace.span("tamp.t.worker"):
            trace.count("t.n", 2)

    trace.reset()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        with ThreadPoolExecutor(2) as ex:
            with trace.span("tamp.t.root", bytes=5):
                ex.submit(trace.bind(work)).result()
                ex.submit(work).result()
    snap = trace.snapshot()
    by = {s.name: [] for s in snap.spans}
    for s in snap.spans:
        by[s.name].append(s)
    (r,) = by["tamp.t.root"]
    bound, free = by["tamp.t.worker"]
    assert r.attrs == {"bytes": 5} and r.parent is None
    assert (bound.call, bound.parent) == (r.call, r.id)
    assert free.parent is None and free.call == free.id != r.call
    assert snap.counters == {"t.n": 4}
    trace.reset()
    after = trace.snapshot()
    assert after.spans == () and after.counters == {}
    assert after.launches == snap.launches
    with trace.span("tamp.t.off", bytes=1):
        trace.count("t.off", 1)
    assert trace.snapshot() == after

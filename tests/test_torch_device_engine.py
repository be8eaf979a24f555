"""``engine="device"`` of the port (kernel B5's tables and the host table
committer) against the JAX package, byte for byte.

- The committer: ``engine/greedy.table_compress`` (and its C entry with
  the flags only tests set: exact tables, a forced empty plan) against
  ``tamp_tpu._native.native_compress`` given the same tables, ``khat``,
  plan, ``avoid_divergence`` and ``exact_tables``: the extended format,
  lazy matching off and on, windows 8, 10 and 15, literals 5-8, default
  and custom dictionaries, on run-heavy inputs and inputs whose runs and
  extended matches meet the ring end, and a seeded sweep.  v1 has no
  committer of its own: its ``engine="device"`` streams (the card's v1
  encode) are held against the JAX ``encode_v1`` on the same inputs.
- The streams: ``engine/pipeline.encode_device(device="cpu")`` against the
  JAX ``encode_device`` (its Pallas search in interpret mode) and, at
  larger sizes, against ``encode_extended`` / ``encode_v1`` on the NumPy
  oracle's tables.
- The containers: ``compress_sharded(engine="device", device="cpu")``
  against the JAX ``compress_sharded(engine="tables")`` (the JAX
  ``engine="device"`` runs the native engine on a host without Pallas; its
  ``"tables"`` engine is the same pipeline on the oracle's tables), and
  ``compress_file_sharded`` against ``compress_sharded``.
"""

import io

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu.engine.encode import encode_v1 as jax_encode_v1
from tamp_tpu.engine.encode_extended import encode_extended as jax_encode_ext
from tamp_tpu.engine.pipeline import encode_device as jax_encode_device
from tamp_tpu.engine.search_np import match_tables
from tamp_tpu.exceptions import ExcessBitsError as JaxExcessBitsError
from tamp_tpu.parallel.shard import compress_sharded as jax_compress_sharded
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine import greedy
from tamp_tpu_torch.engine.encode_extended import (
    commit_extended, encode_extended, model_inputs,
)
from tamp_tpu_torch.engine.greedy import (
    SPARSE_NONE, greedy_compress, table_compress,
)
from tamp_tpu_torch.engine.pipeline import (
    card_tables, encode_device, encode_device_batch, unpack_tables,
)
from tamp_tpu_torch.engine.plan import build_model_history, plan_runs
from tamp_tpu_torch.exceptions import ExcessBitsError
from tamp_tpu_torch.parallel.shard import (
    compress_file_sharded, compress_sharded, decompress_sharded_device,
)


def _text(rng, n: int, lmask: int) -> bytes:
    words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
             for k in rng.integers(2, 9, 48)]
    return bytes([0x20 & lmask]).join(
        words[int(i)] for i in rng.integers(0, 48, n))[:n]


def _mixed(rng, n: int, lmask: int) -> bytes:
    """Seeded mix of runs (1-700 bytes), periodic stretches, text, copies of
    earlier pieces and noise."""
    out, tot = [], 0
    while tot < n:
        k = int(rng.integers(0, 5))
        if k == 0:
            piece = bytes([int(rng.integers(0, 4)) & lmask]) * int(
                rng.integers(1, 700))
        elif k == 1:
            p = bytes(int(x) & lmask
                      for x in rng.integers(0, 256, int(rng.integers(2, 40))))
            c = int(rng.integers(20, 500))
            piece = (p * (c // len(p) + 1))[:c]
        elif k == 2:
            piece = _text(rng, int(rng.integers(5, 200)), lmask)
        elif k == 3 and out:
            piece = out[int(rng.integers(0, len(out)))][
                : int(rng.integers(1, 300))]
        else:
            piece = bytes(int(x) & lmask
                          for x in rng.integers(0, 256, int(rng.integers(1, 50))))
        out.append(piece)
        tot += len(piece)
    return b"".join(out)[:n]


def _ring_end(rng, W: int, lmask: int) -> bytes:
    """Runs starting W - 1 to W + 1 bytes into the input, a run longer than
    W (at most 4133 bytes), then a periodic stretch (extended matches)
    that starts 60 model bytes before a ring end and a run that starts 3
    input bytes before one.  Text holds no run of 9, so the model keeps
    every text byte."""
    out = b""
    for k in (-1, 0, 1):
        out += _text(rng, W + k, lmask)
        out += bytes([3 & lmask]) * int(rng.integers(9, 40))
    out += bytes([1 & lmask]) * (min(W, 4096) + 37)
    out += _text(rng, (W - 60 - _model_len(out, W)) % W, lmask)
    p = _text(rng, 23, lmask)
    out += p * (400 // len(p))
    out += _text(rng, (W - 3 - len(out)) % W, lmask)
    return out + bytes([2 & lmask]) * 20 + _text(rng, 40, lmask)


def _model_len(data: bytes, W: int) -> int:
    arr = np.frombuffer(data, np.uint8)
    return int(build_model_history(arr, plan_runs(arr),
                                   W.bit_length() - 1)[1][-1])


def _ring_runs(rng, W: int, lmask: int, tail: bool = False) -> list:
    """Inputs with a run of k + 1 equal bytes (k = 2-8 short, 9-250
    planned) whose RLE part starts r = 1, 2, 3, 5, 9 or 10 model bytes
    before a ring end: all in one input, or (``tail``) one input per
    (r, k) ending with its run, where the flush drain splits it."""
    out, one = [], b""
    for r in (1, 2, 3, 5, 9, 10):
        for k in (2, 3, 8) if tail else (2, 3, 5, 8, 9, 12, 250):
            z = bytes([(28 + (r + k) % 3) & lmask])  # no text byte
            head = one if not tail else _text(rng, 40, lmask)
            m = _model_len(head, W)
            head += _text(rng, (W - r - 1 - m) % W, lmask)
            if tail:
                out.append(head + z * (k + 1))
            else:
                one = head + z * (k + 1) + _text(rng, 5, lmask)
    return out if tail else [one]


def _dict(rng, window: int, literal: int, custom: bool, extended: bool):
    """(dictionary argument, the initial window as an array)."""
    W = 1 << window
    if custom:
        d = bytes(int(x) & ((1 << literal) - 1)
                  for x in rng.integers(97, 123, W))
        return d, np.frombuffer(d, np.uint8)
    return None, dictionary_array(W, literal=literal if extended else 8)


def _oracle_tables(rows, dict_arr, window: int, literal: int,
                   extended: bool, lazy: bool):
    """(flen, fidx[, plen, pidx]) of ``rows`` against ``dict || rows`` at
    the format's cap, from the JAX package: its NumPy oracle below window
    15, its native exact tables at 15 (the oracle's O(N·W) is too slow
    there); the committers read them the same either way."""
    minp = 2 + (window > 10 + ((literal - 5) << 1))
    cap = 16 if extended else min(16, minp + 13)
    if window < 15:
        t = match_tables(rows, dict_arr, window, compute_probe=lazy)
        out = (t.len16, t.idx16) if cap == 16 else (t.len15, t.idx15)
        return out + ((t.probe_len, t.probe_idx) if lazy else ())
    return _native.native_v1_tables(rows, window, literal, cap,
                                    dictionary=dict_arr.tobytes(), probe=lazy)


class _Tables:
    """The JAX committer's MatchTables view of table arrays."""

    def __init__(self, flen, fidx, plen=None, pidx=None):
        self.len16 = self.len15 = flen
        self.idx16 = self.idx15 = fidx
        self.probe_len, self.probe_idx = plen, pidx


def _commit_cases(rng, window: int, literal: int, lazy: bool, custom: bool,
                  data: bytes):
    """(committer keywords, tables) cases of one input: the planned mode on
    the model history's tables (a plan, a forced empty plan), and the
    unplanned mode on the raw input's tables, with divergence avoidance
    and exact tables cycled."""
    dictionary, dict_arr = _dict(rng, window, literal, custom, True)
    arr = np.frombuffer(data, np.uint8)
    base = dict(window=window, literal=literal, lazy_matching=lazy,
                dictionary=dictionary)
    plans = plan_runs(arr)
    _keep, khat, dh = build_model_history(arr, plans, window)
    rows = np.minimum(khat[:-1], max(0, dh.shape[0] - 1))
    mt = _oracle_tables(dh, dict_arr, window, literal, True, lazy)
    gathered = tuple(np.asarray(t)[rows] for t in mt)
    raw = _oracle_tables(arr, dict_arr, window, literal, True, lazy)
    for planned, avoid, exact in (
            ("plan", True, False), ("plan", False, False),
            ("forced", True, False), ("none", False, True),
            ("none", True, False), ("plan", False, True)):
        kw = dict(base, avoid_divergence=avoid, exact_tables=exact)
        if planned == "none":
            yield kw, raw
            continue
        kw.update(khat=khat, plan=plans, force_planned=planned == "forced")
        yield kw, gathered


def _c_table_compress(data, *, window: int, literal: int,
                      lazy_matching: bool = False, dictionary=None,
                      tables=None, khat=None, plan=None,
                      avoid_divergence: bool = False,
                      exact_tables: bool = False,
                      force_planned: bool = False) -> bytes:
    """The committer's C entry with every flag of native_compress:
    ``table_compress`` where it has them, else the entry called as
    table_compress calls it, with exact tables or a plan pointer holding
    no pairs."""
    if not (exact_tables or force_planned):
        return table_compress(
            data, window=window, literal=literal,
            lazy_matching=lazy_matching, dictionary=dictionary,
            tables=tables, khat=khat, plan=plan,
            avoid_divergence=avoid_divergence)
    arr = np.frombuffer(bytes(data), np.uint8)
    planes = greedy._planes(tables, arr.shape[0], window, lazy_matching)
    kh = None if khat is None else np.ascontiguousarray(khat, np.uint32)
    has_plan = plan is not None and len(plan) > 0
    pl = None
    if has_plan or force_planned:
        pl = np.ascontiguousarray(plan if has_plan else np.zeros(2),
                                  np.int64).reshape(-1)
    return greedy._compress(
        "tpt_table_compress", arr, literal,
        *(greedy._ptr(p) for p in planes),
        greedy._ptr(greedy.window_array(window, literal, dictionary)),
        window, literal, int(lazy_matching), int(dictionary is not None),
        int(avoid_divergence), int(exact_tables), greedy._ptr(kh),
        greedy._ptr(pl), pl.shape[0] // 2 if has_plan else 0)


def _native_equal(kw, tabs, data: bytes):
    """The port's committer and native_compress on the same case: equal
    streams, or the same exception."""
    def run(fn, tables):
        try:
            return fn(data, tables=tables, **kw)
        except (ExcessBitsError, JaxExcessBitsError):
            return "ExcessBitsError"

    got = run(_c_table_compress, tabs)
    want = run(_native.native_compress, _Tables(*tabs))
    assert got == want, {k: v for k, v in kw.items()
                         if k not in ("khat", "plan", "dictionary")}
    return got


_WINDOW_SIZES = {8: 3000, 10: 2500, 15: 6000}
_V1_SIZES = {8: 1500, 10: 1200, 15: 500}


def _v1_equal(rng, data: bytes, *, custom: bool, **kw) -> bool:
    """The v1 ``engine="device"`` stream against the JAX ``encode_v1``:
    equal streams, or ExcessBitsError from both; True for a stream."""
    dictionary, _arr = _dict(rng, kw["window"], kw["literal"], custom, False)
    try:
        want = jax_encode_v1(data, dictionary=dictionary, **kw)
    except JaxExcessBitsError:
        with pytest.raises(ExcessBitsError):
            encode_device(data, extended=False, dictionary=dictionary,
                          device="cpu", **kw)
        return False
    assert encode_device(data, extended=False, dictionary=dictionary,
                         device="cpu", **kw) == want
    return True


@pytest.mark.parametrize("window", [8, 10, 15])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("extended", [True, False])
def test_table_commit_equals_native(extended, lazy, window):
    """Extended: the committer against native_compress on every case of
    :func:`_commit_cases`.  v1: the ``engine="device"`` stream (the card's
    v1 encode on the plain versions) against the JAX ``encode_v1`` on the
    same inputs."""
    rng = np.random.default_rng(window * 4 + 2 * extended + lazy)
    literals = {8: (5, 6, 7, 8), 10: (5, 8), 15: (8, 6)}[window]
    streams = 0
    for literal in literals:
        lmask = (1 << literal) - 1
        for custom in (False, True):
            if window == 15 and custom and literal == 6:
                continue
            if not extended:  # B5's plain version is O(N·W): no ring end
                streams += _v1_equal(
                    rng, _mixed(rng, _V1_SIZES[window], lmask),
                    window=window, literal=literal, lazy_matching=lazy,
                    custom=custom)
                continue
            data = (_ring_end(rng, 1 << window, lmask)
                    + _mixed(rng, _WINDOW_SIZES[window], lmask))
            for kw, tabs in _commit_cases(rng, window, literal, lazy, custom,
                                          data):
                streams += isinstance(_native_equal(kw, tabs, data), bytes)
    assert streams > 0


@pytest.mark.parametrize("seed", range(4))
def test_table_commit_sweep(seed):
    """Seeded random configurations and inputs, holes in the tables."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(8):
        window = int(rng.choice([8, 9, 10, 11, 12]))
        literal = int(rng.integers(5, 9))
        lazy = bool(rng.integers(0, 2))
        data = _mixed(rng, int(rng.integers(0, 4000)),
                      (1 << literal) - 1 if rng.random() < 0.9 else 255)
        for kw, tabs in _commit_cases(rng, window, literal, lazy,
                                      bool(rng.random() < 0.3), data):
            if rng.random() < 0.3:  # holes: the committer searches there
                hole = rng.random(len(data)) < 0.5
                tabs = tuple(np.where(hole, SPARSE_NONE, t) if k % 2 == 0
                             else t for k, t in enumerate(tabs))
            _native_equal(kw, tabs, data)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_table_commit_runs_at_the_ring_end(lazy, tail):
    """Planned-mode RLE splits at the ring end, in the walk and in the
    flush drain, and forced chunks whose write stops short of it."""
    rng = np.random.default_rng(31 + 2 * lazy + tail)
    for window, literal in ((8, 8), (9, 5)):
        lmask = (1 << literal) - 1
        for data in _ring_runs(rng, 1 << window, lmask, tail):
            for kw, tabs in _commit_cases(rng, window, literal, lazy, False,
                                          data):
                assert isinstance(_native_equal(kw, tabs, data), bytes)


@pytest.mark.parametrize("lazy", [False, True])
def test_exact_table_mode_equals_greedy_compress(lazy):
    """tpt_greedy_compress is tpt_table_compress in exact-table mode
    without a plan: the greedy-parity streams."""
    rng = np.random.default_rng(77 + lazy)
    for window, literal in ((8, 8), (10, 6), (11, 5)):
        lmask = (1 << literal) - 1
        data = _ring_end(rng, 1 << window, lmask) + _mixed(rng, 3000, lmask)
        arr = np.frombuffer(data, np.uint8)
        tabs = _oracle_tables(arr, dictionary_array(1 << window, literal),
                              window, literal, True, lazy)
        kw = dict(window=window, literal=literal, lazy_matching=lazy)
        want = greedy_compress(data, **kw)
        assert want == greedy_compress(data, tables=tabs, **kw)
        assert _c_table_compress(data, tables=tabs, exact_tables=True,
                                 **kw) == want
        assert _c_table_compress(data, exact_tables=True, **kw) == want


def test_table_commit_rejects_bad_arguments():
    data = b"abcabcabc" * 20 + b"z" * 40
    n = len(data)
    plans = np.asarray([[10, 20]], np.int64)
    with pytest.raises(ValueError, match="khat"):
        table_compress(data, plan=plans)
    khat = np.arange(n + 1, dtype=np.uint32)
    with pytest.raises(ValueError, match="n \\+ 1"):
        table_compress(data, plan=plans, khat=khat[:-1])
    for bad in (khat * 2, khat[::-1].copy(), khat + 1):
        with pytest.raises(ValueError, match="from 0 in steps of 0 or 1"):
            table_compress(data, plan=plans, khat=bad)
    for bad in ([[10, 20], [5, 30]], [[10, n + 1]], [[-1, 4]], [[20, 10]]):
        with pytest.raises(ValueError, match="sorted"):
            table_compress(data, plan=np.asarray(bad), khat=khat)
    with pytest.raises(ValueError, match="Dictionary"):
        table_compress(data, dictionary=b"x" * 100)
    with pytest.raises(ValueError, match="probe"):
        table_compress(data, lazy_matching=True,
                       tables=(np.zeros(n, np.uint8), np.zeros(n, np.int32)))
    # an empty plan is no plan, as in native_compress
    assert table_compress(data, plan=np.zeros((0, 2)), khat=khat) \
        == _native.native_compress(data, plan=np.zeros((0, 2)), khat=khat)


@pytest.mark.parametrize("literal", [5, 6, 7])
@pytest.mark.parametrize("lazy", [False, True])
def test_v1_excess_bits_where_commit_v1_raises(literal, lazy):
    """The v1 default dictionary is drawn at literal 8: a wide byte the
    window holds is matched, a wide literal raises, in both packages."""
    lmask = (1 << literal) - 1
    rng = np.random.default_rng(literal)
    dict8 = dictionary_array(1 << 8, literal=8).tobytes()
    body = _text(rng, 400, lmask)
    for data in (body + dict8[100:140] + body[:60],   # matched wide bytes
                 body + b"\xf3" + body[:50],           # a wide literal
                 dict8[:4] + body,
                 body[:200] + dict8[200:203] + b"e" + body[:20]):
        kw = dict(window=8, literal=literal, lazy_matching=lazy)
        try:
            want = jax_encode_v1(data, **kw)
        except JaxExcessBitsError:
            with pytest.raises(ExcessBitsError):
                encode_device(data, extended=False, device="cpu", **kw)
            continue
        assert encode_device(data, extended=False, device="cpu",
                             **kw) == want


@pytest.mark.parametrize("extended,lazy,window,literal", [
    (True, False, 10, 8), (True, True, 8, 6), (False, False, 10, 8),
    (False, True, 9, 7)])
def test_stream_equals_jax_encode_device(extended, lazy, window, literal):
    """Against the JAX pipeline itself, its Pallas search in interpret
    mode (a few seconds a call)."""
    rng = np.random.default_rng(window + literal)
    lmask = (1 << literal) - 1
    W = 1 << window
    data = (_text(rng, W + 1, lmask) + bytes([2]) * (W + 3)
            + _mixed(rng, 1500, lmask))
    kw = dict(window=window, literal=literal, extended=extended,
              lazy_matching=lazy)
    assert encode_device(data, device="cpu", **kw) == jax_encode_device(
        data, **kw)


@pytest.mark.parametrize("extended,lazy,window,literal,custom", [
    (True, False, 8, 8, False), (True, True, 8, 5, True),
    (True, False, 10, 7, False), (True, True, 12, 8, True),
    (False, False, 8, 5, True), (False, True, 9, 6, False),
    (False, False, 15, 8, False)])
def test_stream_equals_jax_encoders_on_the_oracle(extended, lazy, window,
                                                  literal, custom):
    rng = np.random.default_rng(window * 8 + literal)
    lmask = (1 << literal) - 1
    W = 1 << window
    if window >= 12:  # B5's plain version and the oracle are slow there
        data = _text(rng, 600, lmask) + bytes([5 & lmask]) * 300
    else:
        data = _ring_end(rng, W, lmask) + _mixed(rng, W, lmask)
    dictionary, _arr = _dict(rng, window, literal, custom, extended)
    kw = dict(window=window, literal=literal, lazy_matching=lazy,
              dictionary=dictionary)
    got = encode_device(data, extended=extended, device="cpu", **kw)
    want = (jax_encode_ext(data, **kw) if extended
            else jax_encode_v1(data, **kw))
    assert got == want
    if extended:
        assert encode_extended(data, device="cpu", **kw) == want
        # each commit alone, on B5's plain tables gathered as the batch
        # gathers them
        arr = np.frombuffer(data, np.uint8)
        plans, khat, dh = model_inputs(arr, window)
        planes = card_tables([dh], greedy.window_array(window, literal,
                                                       dictionary),
                             "cpu", window=window, lazy=lazy)
        rows = np.minimum(khat[:-1], max(0, dh.shape[0] - 1))
        tabs = unpack_tables(planes[:, 0, rows])
        for avoid in (True, False):
            assert commit_extended(
                arr, plans, khat, tabs, avoid_divergence=avoid,
                **kw) == jax_encode_ext(data, avoid_divergence=avoid, **kw)


def test_empty_and_short_shards():
    for extended in (True, False):
        for lazy in (False, True):
            kw = dict(extended=extended, lazy_matching=lazy)
            shards = [b"", b"a", b"abcab", b"z" * 17, b"hello hello hel"]
            got = encode_device_batch(shards, device="cpu", **kw)
            assert got == [jax_encode_ext(s, lazy_matching=lazy) if extended
                           else jax_encode_v1(s, lazy_matching=lazy)
                           for s in shards]
            assert encode_device_batch([], device="cpu", **kw) == []


@pytest.mark.parametrize("kw", [
    {}, {"lazy_matching": True}, {"extended": False},
    {"extended": False, "lazy_matching": True, "window": 9, "literal": 7}])
def test_container_equals_jax_tables_engine(kw):
    lmask = (1 << kw.get("literal", 8)) - 1
    rng = np.random.default_rng(len(kw))
    data = _mixed(rng, 7000, lmask)
    got = compress_sharded(data, engine="device", shard_size=2048,
                           device="cpu", **kw)
    assert got == jax_compress_sharded(data, engine="tables",
                                       shard_size=2048, **kw)
    assert bytes(decompress_sharded_device(got, device="cpu")) == data


@pytest.mark.parametrize("extended", [True, False])
def test_file_container_equals_compress_sharded(tmp_path, extended):
    rng = np.random.default_rng(5)
    data = _mixed(rng, 2000, 255)  # 7 shards of 300 bytes, the last 200
    kw = dict(extended=extended, window=8, shard_size=300, device="cpu")
    want = compress_sharded(data, engine="device", **kw)
    for workers in (1, 3):  # batches of 2 and of 6 shards
        dst = io.BytesIO(b"prefix")
        dst.seek(6)
        n = compress_file_sharded(io.BytesIO(data), dst, workers=workers,
                                  engine="device", **kw)
        assert n == len(want) and dst.getvalue() == b"prefix" + want
    src = tmp_path / "raw.bin"
    src.write_bytes(data)
    assert compress_file_sharded(src, tmp_path / "out.ttpu", workers=2,
                                 lazy_matching=True, engine="device",
                                 **kw) == len(
        (tmp_path / "out.ttpu").read_bytes())
    assert (tmp_path / "out.ttpu").read_bytes() == compress_sharded(
        data, engine="device", lazy_matching=True, **kw)
    empty = io.BytesIO()
    compress_file_sharded(io.BytesIO(b""), empty, engine="device", **kw)
    assert empty.getvalue() == compress_sharded(b"", engine="device", **kw)


def test_file_path_refuses_other_engines():
    with pytest.raises(ValueError, match="device-commit batches"):
        compress_file_sharded(io.BytesIO(b"abc"), io.BytesIO(),
                              engine="device-commit", device="cpu")
    # the other engines stream a batch of 2 * workers shards at a time, each
    # equal to the JAX container of its name ("device-optimal": "optimal")
    rng = np.random.default_rng(6)
    data = _mixed(rng, 2000, 255)  # 7 shards of 300 bytes, the last 200
    # (the v1 optimal encode: X4's plain version, the extended one, takes
    # minutes on batches of several shards)
    for engine, jax_engine, extended in (
            ("device-optimal", "optimal", False), ("tables", "tables", True),
            ("native", "native", True)):
        dst = io.BytesIO()
        compress_file_sharded(io.BytesIO(data), dst, engine=engine,
                              extended=extended, shard_size=300, workers=2,
                              device="cpu")
        assert dst.getvalue() == jax_compress_sharded(
            data, engine=jax_engine, extended=extended, shard_size=300), \
            engine
    with pytest.raises(ValueError, match="unknown engine"):
        compress_file_sharded(io.BytesIO(b"abc"), io.BytesIO(),
                              engine="bogus", device="cpu")
    # device-greedy streams the extended format only
    with pytest.raises(ValueError, match="extended-format mode"):
        compress_file_sharded(io.BytesIO(b"abc"), io.BytesIO(),
                              engine="device-greedy", extended=False,
                              device="cpu")


def test_no_card_raises_and_falls_back_to_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_sharded(b"abcabc", engine="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_device(b"abcabc", extended=False)
    dst = tmp_path / "out.ttpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_file_sharded(io.BytesIO(b"abcabc"), dst, engine="device")
    assert not dst.exists()
    # the JAX name "tables" is engine="device" on the card: no card, no
    # encode, and with the CPU asked for, the JAX container
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_sharded(b"abcabc", engine="tables")
    assert compress_sharded(b"abcabc", engine="tables", device="cpu") == \
        jax_compress_sharded(b"abcabc", engine="tables")

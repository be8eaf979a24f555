"""A seeded fuzz of the port against the JAX package on the CPU: 16 cases,
each drawing a configuration (window 8-12, literal 5-8, extended or v1,
lazy matching on or off, an engine among device-commit, device-greedy,
device-optimal and device (each in both formats and, where it applies,
lazy and not), a custom dictionary or none, a shard size of
257-4096) and 0-12 KB of runs, repeats and noise within the literal.

1. The port's container (``compress_sharded(device="cpu")``) equals the
   JAX package's: the engine's per-shard reference encoder of the JAX
   package (the native planned committer, native v1, the reference greedy
   encoder, the host optimal DPs, ``encode_extended`` / ``encode_v1``),
   framed by the JAX package.
2. The port's decode of it, in memory and from a file, in modes commit,
   chase and xla and by the serial algorithm, gives the input back."""

import io

import numpy as np
import pytest
import torch

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu.engine.encode import encode_extended_optimal, encode_v1
from tamp_tpu.engine.encode_extended import encode_extended
from tamp_tpu.engine.search_np import MatchTables
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.parallel import shard as tshard

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine needed")

N_CASES = 16
ENGINES = ("device-commit", "device-greedy", "device-optimal", "device")
MODES = ("commit", "chase", "xla")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op thread
    runs them about as fast here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, n: int, lmask: int) -> bytes:
    """``n`` bytes of runs (2-300 bytes), repeats of earlier bytes (3-200,
    at most 4096 back) and noise over a small alphabet, each byte within
    ``lmask``."""
    alphabet = rng.integers(0, lmask + 1, int(rng.integers(2, 24)))
    out = bytearray()
    while len(out) < n:
        kind = int(rng.integers(3))
        if kind == 0:
            out += bytes([int(rng.choice(alphabet))]) * int(
                rng.integers(2, 301))
        elif kind == 1 and len(out) > 3:
            k = int(rng.integers(3, 201))
            at = int(rng.integers(max(0, len(out) - 4096), len(out) - 2))
            out += (out[at:] * (k // max(1, len(out) - at) + 1))[:k]
        else:
            out += bytes(rng.choice(alphabet, int(rng.integers(1, 201)))
                         .astype(np.uint8))
    return bytes(out[:n])


def _case(seed: int) -> dict:
    rng = np.random.default_rng(1000 + seed)
    # each engine in both formats, lazy matching on and off where they apply
    engine = ENGINES[seed % len(ENGINES)]
    extended = engine == "device-greedy" or seed // 4 % 2 == 0
    lazy = engine != "device-optimal" and seed // 8 == 1
    window, literal = int(rng.integers(8, 13)), int(rng.integers(5, 9))
    lmask = (1 << literal) - 1
    data = _data(rng, int(rng.integers(0, 12 * 1024 + 1)), lmask)
    dictionary = None
    if rng.integers(2):  # a full window of the data's kind
        dictionary = _data(rng, 1 << window, lmask)
    return dict(engine=engine, window=window, literal=literal,
                extended=extended, lazy_matching=lazy, dictionary=dictionary,
                shard_size=int(rng.integers(257, 4097)), data=data)


def _native_planned(raw: bytes, window: int, literal: int, lazy: bool,
                    dictionary) -> bytes:
    """The native planned committer (__graft_entry__.py:103-113), with
    the probe tables under lazy matching and a custom dictionary."""
    arr = np.frombuffer(raw, np.uint8)
    plans, khat, dh, _rc = _native.native_ext_prep(arr, window)
    tabs = _native.native_v1_tables(dh, window, literal, 16,
                                    dictionary=dictionary, ext_dict=True,
                                    probe=lazy)
    rows = np.minimum(khat[:-1].astype(np.int64), max(0, dh.shape[0] - 1))
    l16, i16, *probe = (t[rows] for t in tabs)
    return _native.native_compress(
        arr.tobytes(), window=window, literal=literal, extended=True,
        lazy_matching=lazy, tables=MatchTables(l16, i16, l16, i16, *probe),
        avoid_divergence=True, khat=khat, plan=plans, force_planned=True,
        dictionary=dictionary)


def _jax_stream(shard: bytes, c: dict) -> bytes:
    """The JAX package's stream of ``shard`` for case ``c``'s engine."""
    w, lit, lazy, d = (c["window"], c["literal"], c["lazy_matching"],
                       c["dictionary"])
    kw = dict(window=w, literal=lit, dictionary=d)
    engine, extended = c["engine"], c["extended"]
    if engine == "device-optimal":
        if extended:
            return encode_extended_optimal(shard, **kw)
        return encode_v1(shard, parse="optimal", **kw)
    if engine == "device":
        if extended:
            return encode_extended(shard, lazy_matching=lazy, **kw)
        return encode_v1(shard, lazy_matching=lazy, **kw)
    if engine == "device-commit" and extended:
        return _native_planned(shard, w, lit, lazy, d)
    # device-greedy: the reference greedy encoder; v1 device-commit: native
    return tamp_tpu.compress(shard, extended=extended, lazy_matching=lazy,
                             **kw)


@pytest.mark.parametrize("seed", range(N_CASES))
def test_port_container_equals_jax_and_decodes(seed, monkeypatch):
    c = _case(seed)
    data, ss, d = c["data"], c["shard_size"], c["dictionary"]
    kw = {k: c[k] for k in ("engine", "window", "literal", "extended",
                            "lazy_matching", "dictionary")}
    blob = tshard.compress_sharded(data, shard_size=ss, device="cpu", **kw)
    shards = [data[i : i + ss] for i in range(0, len(data), ss)] or [b""]
    assert blob == jshard._pack_frame(
        [_jax_stream(s, c) for s in shards], len(data), ss), \
        {k: v for k, v in c.items() if k not in ("data", "dictionary")}
    workers = 1 + seed % 3  # batches of 2, 4 and 6 shards
    for algorithm, mode in [("wavefront", m) for m in MODES] + [
            ("serial", "commit")]:
        monkeypatch.setenv("TAMP_TPU_DECODE", mode)
        back = tshard.decompress_sharded_device(
            blob, algorithm=algorithm, dictionary=d, device="cpu")
        assert bytes(back) == data, (algorithm, mode)
        out = io.BytesIO()
        n = tshard.decompress_file_sharded(
            io.BytesIO(blob), out, workers, d, algorithm=algorithm,
            device="cpu")
        assert out.getvalue() == data and n == len(data), (algorithm, mode)

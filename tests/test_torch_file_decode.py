"""The port's bounded-memory file decode
(tamp_tpu_torch.parallel.shard.decompress_file_sharded) on the CPU, against
the JAX package's decompress_file_sharded: containers written by either
package, in every decode mode (commit, chase, xla) and by the serial
algorithm, at batches of 2 shards and the default; the frame errors, a
truncated shard and a header change in a later batch raise ValueError."""

import io
import struct

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.parallel import shard as tshard

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine needed")

SHARD = 4096
# (algorithm, TAMP_TPU_DECODE): the wavefront's three modes and X2
MODES = (("wavefront", "commit"), ("wavefront", "chase"),
         ("wavefront", "xla"), ("serial", "commit"))
MODE_IDS = [m if a == "wavefront" else a for a, m in MODES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op thread
    runs them about as fast here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(seed: int, n: int) -> bytes:
    """Seeded words with a run and a repeat (matches, RLE, literals)."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, int(k)).astype(np.uint8))
             for k in rng.integers(2, 9, 120)]
    text = b" ".join(words[i] for i in rng.integers(0, 120, n // 4))
    return (text[: n // 2] + b"\x00" * 300 + text[100:400]
            + text[n // 2 :])[:n]


DICT = bytes(np.random.default_rng(9).integers(97, 123, 1024)
             .astype(np.uint8))
DATA = _corpus(1, 30000)  # 8 shards, the last short


def _decode(blob, mode, monkeypatch, **kw) -> tuple[int, bytes]:
    algorithm, env = mode
    monkeypatch.setenv("TAMP_TPU_DECODE", env)
    out = io.BytesIO()
    n = tshard.decompress_file_sharded(io.BytesIO(blob), out,
                                       algorithm=algorithm, device="cpu",
                                       **kw)
    return n, out.getvalue()


def _jax_decode(blob, **kw) -> bytes:
    out = io.BytesIO()
    jshard.decompress_file_sharded(io.BytesIO(blob), out, **kw)
    return out.getvalue()


# JAX-written containers: name, compress_sharded options
JAX_CONTAINERS = (
    ("extended", {}),
    ("extended lazy", {"lazy_matching": True}),
    ("v1", {"extended": False}),
    ("v1 lazy", {"extended": False, "lazy_matching": True}),
    ("custom dictionary", {"dictionary": DICT}),
    ("v1 custom dictionary w9 l7", {"extended": False, "window": 9,
                                    "literal": 7, "dictionary": DICT[:512]}),
)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name,kw", JAX_CONTAINERS,
                         ids=[c[0] for c in JAX_CONTAINERS])
def test_jax_container_decodes_as_jax_does(name, kw, mode, monkeypatch):
    data = DATA if "l7" not in name else bytes(b & 0x7F for b in DATA)
    blob = jshard.compress_sharded(data, shard_size=SHARD, **kw)
    dictionary = kw.get("dictionary")
    want = _jax_decode(blob, dictionary=dictionary)
    assert want == data
    for workers in (None, 1):  # one batch of 8 shards; batches of 2
        n, got = _decode(blob, mode, monkeypatch, workers=workers,
                         dictionary=dictionary)
        assert got == want and n == len(data)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_jax_file_container_decodes(mode, monkeypatch, tmp_path):
    src, blob = tmp_path / "in.bin", tmp_path / "out.ttpu"
    src.write_bytes(DATA)
    jshard.compress_file_sharded(src, blob, shard_size=SHARD, workers=3)
    back = tmp_path / "back.bin"
    monkeypatch.setenv("TAMP_TPU_DECODE", mode[1])
    n = tshard.decompress_file_sharded(blob, back, workers=3,
                                       algorithm=mode[0], device="cpu")
    want = tmp_path / "want.bin"
    jshard.decompress_file_sharded(blob, want)
    assert back.read_bytes() == want.read_bytes() == DATA and n == len(DATA)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_port_containers_round_trip_through_both_packages(mode, monkeypatch,
                                                          tmp_path):
    src, dev_blob = tmp_path / "in.bin", tmp_path / "device.ttpu"
    src.write_bytes(DATA)
    tshard.compress_file_sharded(src, dev_blob, shard_size=SHARD,
                                 device="cpu", engine="device")
    blobs = (dev_blob.read_bytes(),
             tshard.compress_sharded(DATA, shard_size=SHARD, device="cpu",
                                     engine="device-commit"))
    for blob in blobs:
        assert _jax_decode(blob) == DATA
        for workers in (None, 1):
            n, got = _decode(blob, mode, monkeypatch, workers=workers)
            assert got == DATA and n == len(DATA)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("payload", [b"", b"tiny"], ids=["empty", "tiny"])
def test_empty_and_one_shard(payload, mode, monkeypatch):
    for blob in (tshard.compress_sharded(payload, shard_size=SHARD,
                                         device="cpu", engine="device-commit"),
                 jshard.compress_sharded(payload, shard_size=SHARD)):
        n, got = _decode(blob, mode, monkeypatch)
        assert got == payload and n == len(payload)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_v1_frame_takes_the_callers_shard_size(mode, monkeypatch):
    # a v1 frame (tests/test_container.py) records no shard size
    blob = jshard.compress_sharded(DATA, shard_size=8192)
    raw, _ss, pieces = jshard._parse_frame(blob)
    v1 = (jshard.MAGIC + struct.pack("<BBIQ", 1, 0, len(pieces), raw)
          + struct.pack(f"<{len(pieces)}I", *(len(b) for b in pieces))
          + b"".join(pieces))
    n, got = _decode(v1, mode, monkeypatch, shard_size=8192, workers=1)
    assert got == DATA and n == len(DATA)


def _bad_containers():
    """name -> (container, the message the port raises with)."""
    blob = jshard.compress_sharded(DATA, shard_size=SHARD)
    raw, ss, pieces = jshard._parse_frame(blob)
    bad_ver = bytearray(blob)
    bad_ver[4] = 9
    bad_size = bytearray(blob)
    struct.pack_into("<Q", bad_size, 10, len(DATA) + 1)
    # shards 6 and 7, the last batch at workers=1, in another header
    # configuration: each batch alone is uniform
    other = jshard.compress_sharded(DATA[6 * SHARD :], shard_size=SHARD,
                                    extended=False)
    mixed = pieces[:6] + jshard._parse_frame(other)[2]
    return {
        # the JAX package's three frame errors, with its messages
        "bad magic": (b"NOPE" + blob[4:], "not a TTPU container"),
        "unknown version": (bytes(bad_ver), "unsupported TTPU version 9"),
        "raw size off by one": (bytes(bad_size),
                                "container raw-size mismatch"),
        # refused before any decode of the short shard
        "truncated shard": (blob[:-3], "truncated TTPU container"),
        "truncated header": (blob[:20], "truncated TTPU container"),
        "header change in a later batch": (
            jshard._pack_frame(mixed, raw, ss), "one header configuration"),
    }


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_bad_containers_raise(mode, monkeypatch):
    for name, (blob, msg) in _bad_containers().items():
        for workers in (None, 1):
            with pytest.raises(ValueError, match=msg):
                _decode(blob, mode, monkeypatch, workers=workers)
        if name in ("bad magic", "unknown version", "raw size off by one"):
            with pytest.raises(ValueError):  # the JAX package raises too
                _jax_decode(blob)


def test_paths_and_files_and_the_return_value(tmp_path, monkeypatch):
    blob = jshard.compress_sharded(DATA, shard_size=SHARD)
    src = tmp_path / "in.ttpu"
    src.write_bytes(blob)
    n = tshard.decompress_file_sharded(src, tmp_path / "a.bin", device="cpu")
    assert n == len(DATA) and (tmp_path / "a.bin").read_bytes() == DATA
    n = tshard.decompress_file_sharded(str(src), str(tmp_path / "b.bin"),
                                       device="cpu")
    assert n == len(DATA) and (tmp_path / "b.bin").read_bytes() == DATA
    with open(src, "rb") as f, open(tmp_path / "c.bin", "wb") as g:
        n = tshard.decompress_file_sharded(f, g, workers=2, device="cpu")
        assert not f.closed and not g.closed  # the caller's files stay open
    assert n == len(DATA) and (tmp_path / "c.bin").read_bytes() == DATA


def test_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    blob = tshard.compress_sharded(b"abc", device="cpu",
                                   engine="device-commit")
    with pytest.raises(RuntimeError):
        tshard.decompress_file_sharded(io.BytesIO(blob), io.BytesIO())
    with pytest.raises(ValueError):
        tshard.decompress_file_sharded(io.BytesIO(blob), io.BytesIO(),
                                       algorithm="bogus", device="cpu")

"""The JAX package's engine names, defaults and host decoder on the port
(``device="cpu"``: the kernels' plain versions), held against the JAX
package byte for byte:

- ``compress_sharded`` with ``engine="native"``, ``"tables"`` and
  ``"optimal"`` (the routes ``device-greedy`` / v1 ``device-commit``,
  ``device`` and ``device-optimal``) over extended and v1, lazy and not,
  windows 8, 10 and 15, literals 5 and 8 and a custom dictionary, against
  the JAX ``compress_sharded`` of the same name;
- the defaults of ``compress_sharded``, ``compress_file_sharded`` and
  ``compress_distributed`` (``"native"``), on the reproduction where the
  port's earlier defaults wrote other containers (3 000 draws from 64
  seeded words, 500 ``a``s, ``shard_size=4096``: 26 568 bytes);
- ``decompress_sharded`` against the JAX one on v2 and v1 frames, errors
  included, and a v1 frame whose one shard decodes past 1 MiB, decoded
  whole by it, by ``decompress_file_sharded`` and by the CLI;
- the int32 limits: a shard past MAX_STREAM_BYTES, or a frame's
  per-shard bound past a decoder's limit, raises ValueError before any
  read or launch (the decoders are replaced by ones that fail if called);
- ``engine.encode_v1`` for both parses;
- the CLI's ``--implementation`` legs and ``--sharded`` against ``python -m
  tamp_tpu``'s ``main`` in process."""

import io
import struct

import numpy as np
import pytest

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu.cli.main import main as jax_main
from tamp_tpu.engine import encode_v1 as jax_encode_v1
from tamp_tpu.exceptions import OutOfBoundsError as JaxOutOfBoundsError
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.cli.main import main
from tamp_tpu_torch.engine import encode_v1
from tamp_tpu_torch.exceptions import OutOfBoundsError
from tamp_tpu_torch.ops import decode_serial, decode_wavefront
from tamp_tpu_torch.parallel import shard as tshard
from tamp_tpu_torch.parallel.distributed import compress_distributed

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="the JAX package's native engine")


def _words(n: int, seed: int, vocab: int = 48) -> bytes:
    """Seeded word text with a run (RLE tokens) in the middle."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8)
             .tobytes() for _ in range(vocab)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, vocab, n))
    return text[: n // 2] + b"=" * 300 + text[n // 2 : n]


def c1_data() -> bytes:
    """The defaults' reproduction: 3 000 draws from 64 seeded words (each
    word the bytes of int64 letters, so zeros too), joined by spaces, and
    500 ``a``s: 130 771 bytes."""
    rng = np.random.default_rng(1)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 10)))
             for _ in range(64)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 64, 3000)) \
        + b"a" * 500


def c2_frame():
    """(data, v1 frame): 2**20 + 4096 bytes of a word text (512 seeded
    words, 200 000 draws), one shard encoded by the JAX native encoder."""
    rng = np.random.default_rng(2)
    words = [rng.integers(97, 123, rng.integers(2, 10)).astype(np.uint8)
             .tobytes() for _ in range(512)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 512, 200000))
    data = text[: (1 << 20) + 4096]
    stream = _native.native_compress(data)
    return data, _v1_frame([stream], len(data))


def _v1_frame(streams, raw_size: int) -> bytes:
    return (b"TTPU" + struct.pack("<BBIQ", 1, 0, len(streams), raw_size)
            + struct.pack(f"<{len(streams)}I", *map(len, streams))
            + b"".join(streams))


def _v2_frame(streams, raw_size: int, shard_size: int) -> bytes:
    return (b"TTPU" + struct.pack("<BBIQQ", 2, 0, len(streams), raw_size,
                                  shard_size)
            + struct.pack(f"<{len(streams)}I", *map(len, streams))
            + b"".join(streams))


# The engine table's rows: each header combination (extended or v1, lazy or
# not) at windows 8, 10 and 15 and literals 5 and 8, each configuration
# twice an engine; "optimal" ignores lazy matching in both packages.  The
# extended "optimal" rows encode one shard a call: X4's plain version runs
# ~60x longer on a batch of two shards than on one.
ROWS = [(True, False, 8, 5), (True, True, 10, 8), (True, False, 15, 8),
        (False, False, 10, 8), (False, True, 8, 5), (False, True, 15, 8)]
OPTIMAL_ROWS = [(True, False, 8, 5), (True, False, 15, 8),
                (False, False, 10, 8), (False, False, 15, 8)]
TABLE = ([("native", *r) for r in ROWS] + [("tables", *r) for r in ROWS]
         + [("optimal", *r) for r in OPTIMAL_ROWS])


@pytest.mark.parametrize("engine,extended,lazy,window,literal", TABLE)
def test_jax_engine_names_equal_jax_containers(engine, extended, lazy, window,
                                               literal):
    lmask = (1 << literal) - 1
    data = bytes(b & lmask for b in _words(100, window + literal))
    # one shard at window 15, where the plain tables cost most
    one = engine == "optimal" and extended or window == 15
    kw = dict(window=window, literal=literal, extended=extended,
              lazy_matching=lazy, shard_size=512 if one else 200,
              engine=engine)
    blob = tshard.compress_sharded(data, device="cpu", **kw)
    assert blob == jshard.compress_sharded(data, **kw)
    assert bytes(tshard.decompress_sharded(blob, device="cpu")) == data


@pytest.mark.parametrize("engine", ["native", "tables", "optimal"])
@pytest.mark.parametrize("extended", [True, False])
def test_jax_engine_names_with_a_custom_dictionary(engine, extended):
    rng = np.random.default_rng(8)
    dictionary = bytes(rng.integers(97, 123, 1024).astype(np.uint8))
    data = dictionary[:100] + _words(60, 12)  # 460 bytes
    one = engine == "optimal" and extended
    kw = dict(extended=extended, dictionary=dictionary,
              shard_size=512 if one else 200, engine=engine)
    blob = tshard.compress_sharded(data, device="cpu", **kw)
    assert blob == jshard.compress_sharded(data, **kw)
    assert bytes(tshard.decompress_sharded(
        blob, dictionary=dictionary, device="cpu")) == data
    assert bytes(jshard.decompress_sharded(blob, dictionary=dictionary)) \
        == data


def test_defaults_equal_jax_on_the_reproduction(tmp_path):
    data = c1_data()
    assert len(data) == 130771
    want = jshard.compress_sharded(data, shard_size=4096)
    assert len(want) == 26568
    assert tshard.compress_sharded(data, shard_size=4096, device="cpu") \
        == want
    src, dst = tmp_path / "in.bin", tmp_path / "out.ttpu"
    src.write_bytes(data)
    jax_dst = tmp_path / "jax.ttpu"
    jshard.compress_file_sharded(src, jax_dst, shard_size=4096)
    assert jax_dst.read_bytes() == want
    tshard.compress_file_sharded(src, dst, shard_size=4096, workers=4,
                                 device="cpu")
    assert dst.read_bytes() == want
    assert compress_distributed(data, shard_size=4096, device="cpu") == want


def test_file_path_streams_every_engine_name(tmp_path):
    data = _words(200, 3)
    for extended in (True, False):
        for engine in ("native", "tables", "optimal"):
            # 5 shards in batches of 2 (workers=1), one shard for the
            # extended optimal encode (X4's plain version, see TABLE)
            ss = 512 if extended and engine == "optimal" else 120
            dst = io.BytesIO()
            tshard.compress_file_sharded(
                io.BytesIO(data), dst, extended=extended, engine=engine,
                shard_size=ss, workers=1, device="cpu")
            assert dst.getvalue() == jshard.compress_sharded(
                data, extended=extended, engine=engine, shard_size=ss), \
                (extended, engine)


def test_decompress_sharded_equals_jax_on_v2_and_v1_frames():
    data = _words(400, 5)
    for kw in ({}, {"extended": False, "lazy_matching": True, "window": 9}):
        blob = jshard.compress_sharded(data, shard_size=500, **kw)
        want = bytes(jshard.decompress_sharded(blob))
        assert want == data
        for workers in (None, 1):  # one batch, and batches of 2 shards
            assert bytes(tshard.decompress_sharded(
                blob, workers, device="cpu")) == want
        _r, _s, pieces = tshard._parse_frame(blob)
        v1 = _v1_frame(pieces, len(data))
        assert bytes(tshard.decompress_sharded(v1, device="cpu")) == \
            bytes(jshard.decompress_sharded(v1)) == data
    # shards of other header configurations in one container, and an
    # empty shard: each decodes alone, as in the JAX package
    a, b = data[:500], data[500:900]
    mixed = [_native.native_compress(a), _native.native_compress(
        b, window=8, literal=7, extended=False)]
    for streams, want in ((mixed, a + b), (mixed[:1] + [b""], a)):
        blob = _v2_frame(streams, len(want), 500)
        assert bytes(tshard.decompress_sharded(blob, device="cpu")) == \
            bytes(jshard.decompress_sharded(blob)) == want


def _raises_alike(blob, **kw):
    """The JAX and the port's decompress_sharded raise the same class."""
    with pytest.raises(ValueError) as want:
        jshard.decompress_sharded(blob, **kw)
    with pytest.raises(ValueError) as got:
        tshard.decompress_sharded(blob, device="cpu", **kw)
    assert isinstance(got.value, OutOfBoundsError) == isinstance(
        want.value, JaxOutOfBoundsError), (want.value, got.value)
    return got.value


def test_decompress_sharded_errors_equal_jax():
    # a w8 v1 match at slot 255 of size 2 reads past the window
    oob = bytes([0x18, 0x3F, 0xC0])
    assert isinstance(_raises_alike(_v2_frame([oob], 2, 2)),
                      OutOfBoundsError)
    good = _native.native_compress(b"abcabcabc" * 20)
    # a nonzero reserved header byte
    bad = bytes([good[0] | 1, 7]) + good[1:]
    _raises_alike(_v2_frame([bad], 180, 180))
    # raw sizes that the shards do not fill, or overflow
    assert "raw-size" in str(_raises_alike(_v2_frame([good], 200, 200)))
    assert "exceeds" in str(_raises_alike(_v2_frame([good], 100, 100)))
    assert "raw-size" in str(_raises_alike(_v1_frame([good], 181)))
    # a custom-dictionary stream without its dictionary
    d = bytes(range(256)) * 4
    custom = _native.native_compress(b"hello " * 30, dictionary=d)
    _raises_alike(_v2_frame([custom], 180, 180))
    assert bytes(tshard.decompress_sharded(
        _v2_frame([custom], 180, 180), dictionary=d, device="cpu")) == \
        b"hello " * 30
    # a truncated frame, and a shard past the raw size
    _raises_alike(_v2_frame([good], 180, 180)[:-3])
    assert "raw-size" in str(_raises_alike(_v2_frame([good, b""], 180, 200)))


def test_v1_frame_past_one_mib_decodes_whole(tmp_path):
    data, blob = c2_frame()
    assert len(data) == (1 << 20) + 4096
    assert bytes(jshard.decompress_sharded(blob)) == data
    assert bytes(tshard.decompress_sharded(blob, device="cpu")) == data
    # the CLI's file-to-file container route is decompress_file_sharded
    # (its in-memory route, from stdin, is decompress_sharded)
    src, out = tmp_path / "c2.ttpu", tmp_path / "cli.out"
    src.write_bytes(blob)
    assert main(["decompress", "-i", str(src), "--device", "cpu", "-o",
                 str(out)]) == 0
    assert out.read_bytes() == data


class _HugeFile(io.RawIOBase):
    """A readable, seekable file that claims ``n`` bytes and fails if read."""

    def __init__(self, n: int):
        self.n, self.at = n, 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def tell(self):
        return self.at

    def seek(self, off, whence=0):
        self.at = off if whence == 0 else self.n + off
        return self.at

    def read(self, k=-1):
        raise AssertionError("read before the limit was checked")


def test_shards_past_the_int32_limits_raise_before_any_work(monkeypatch):
    from tamp_tpu_torch import MAX_STREAM_BYTES

    big = np.broadcast_to(np.uint8(97), (MAX_STREAM_BYTES + 1,))  # no memory
    for fn in (tshard.compress_sharded, compress_distributed):
        with pytest.raises(ValueError, match="MAX_STREAM_BYTES"):
            fn(big, shard_size=1 << 28, device="cpu")
    dst = io.BytesIO()
    with pytest.raises(ValueError, match="MAX_STREAM_BYTES"):
        tshard.compress_file_sharded(_HugeFile(MAX_STREAM_BYTES + 1), dst,
                                     shard_size=1 << 28, device="cpu")
    assert dst.getvalue() == b""

    # decode: frame headers only; no decoder may run
    def launched(*a, **k):
        raise AssertionError("a decoder ran past the limit")

    monkeypatch.setattr(decode_serial, "decode_shards_device", launched)
    monkeypatch.setattr(decode_serial, "decode_stream", launched)
    monkeypatch.setattr(decode_wavefront, "decode_shards_wavefront", launched)
    stream = _native.native_compress(b"abc")
    serial = decode_serial.MAX_DECODED
    wave = decode_wavefront.MAX_OUT
    # the per-shard bound is min(frame shard_size, raw_size)
    for raw, shard, fn, kw in (
            (serial, serial, tshard.decompress_sharded, {}),
            (1 << 40, serial + 1, tshard.decompress_sharded_device,
             {"algorithm": "serial"}),
            (wave + 1, 1 << 40, tshard.decompress_sharded_device, {}),
            (wave + 1, wave + 1, "file", {})):
        blob = _v2_frame([stream], raw, shard)
        with pytest.raises(ValueError, match="limit"):
            if fn == "file":
                tshard.decompress_file_sharded(io.BytesIO(blob), io.BytesIO(),
                                               device="cpu")
            else:
                fn(blob, device="cpu", **kw)


@pytest.mark.parametrize("extended_dict", [False, True])
def test_engine_encode_v1_equals_jax(extended_dict):
    data = _words(200, 7)
    kw = {}
    if extended_dict:
        kw["dictionary"] = bytes(np.random.default_rng(3).integers(
            97, 123, 1 << 9).astype(np.uint8))
        kw["window"] = 9
    for parse in ("greedy", "optimal"):
        for lazy in (False, True):
            got = encode_v1(data, parse=parse, lazy_matching=lazy,
                            device="cpu", **kw)
            assert got == jax_encode_v1(data, parse=parse,
                                        lazy_matching=lazy, **kw), parse
    with pytest.raises(ValueError, match="parse"):
        encode_v1(data, parse="bogus", device="cpu")
    with pytest.raises(ValueError, match="parse"):
        jax_encode_v1(data, parse="bogus")


CLI_CASES = [
    ["compress", "--implementation", "native"],
    ["compress", "--implementation", "native", "--no-extended", "-w", "9"],
    ["compress", "--implementation", "engine"],
    ["compress", "--implementation", "engine", "--no-extended",
     "--lazy-matching"],
    ["compress", "--implementation", "python", "-l", "7", "--lazy-matching"],
    ["compress", "--sharded", "--shard-size", "700"],
    ["compress", "--sharded", "--shard-size", "700", "--no-extended"],
]


@pytest.mark.parametrize("args", CLI_CASES, ids=" ".join)
def test_cli_implementations_equal_jax(tmp_path, monkeypatch, args):
    src = tmp_path / "in.bin"
    src.write_bytes(_words(150, 11))
    outs = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        out = tmp_path / f"out{len(outs)}"
        assert fn([*args, "-i", str(src), "-o", str(out), *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    if "--sharded" in args:  # in memory, stdin to stdout, alike
        stdout = io.BytesIO()
        monkeypatch.setattr("sys.stdin", io.TextIOWrapper(
            io.BytesIO(src.read_bytes())))
        monkeypatch.setattr("sys.stdout", io.TextIOWrapper(stdout))
        assert main([*args, "--device", "cpu"]) == 0
        assert stdout.getvalue() == outs[0]
        monkeypatch.undo()
    for impl in ("native", "python"):
        back = tmp_path / f"back.{impl}"
        assert main(["decompress", "-i", str(tmp_path / "out0"), "-o",
                     str(back), "--implementation", impl, "--device",
                     "cpu"]) == 0
        assert back.read_bytes() == src.read_bytes()


def test_cli_decompress_implementations_raise_as_jax(tmp_path):
    from tamp_tpu_torch import decompressor

    src = tmp_path / "oob.tamp"
    src.write_bytes(bytes([0x18, 0x3F, 0xC0]))
    for fn, exc in ((jax_main, JaxOutOfBoundsError),
                    (main, OutOfBoundsError)):
        with pytest.raises(exc):
            fn(["decompress", "-i", str(src), "-o", str(tmp_path / "x"),
                "--implementation", "native"])
    # the Python decoder reads such a reference permissively, in both
    # packages
    assert bytes(decompressor.decompress(src.read_bytes())) == bytes(
        tamp_tpu.decompressor.decompress(src.read_bytes()))

"""The port's one-shots, ``tamp_tpu_torch.compress`` and ``decompress``, on
the CPU (the plain versions of kernels B5, B7, B3, B6, X3, X4 and X2)
against the JAX package's ``tamp_tpu.compress`` and ``decompress``: every
stream, decoded output and error class equal (byte-equal: the tolerance is
zero), at windows 8-15 and literals 5-8, extended and v1, lazy and not,
the optimal parse, default and custom dictionaries, inputs of 0 to a few
thousand bytes; the decode's max_out sizing on RLE-heavy streams; the
single-stream limits; no card without ``device="cpu"``."""

import io

import numpy as np
import pytest
import torch

import tamp_tpu
import tamp_tpu_torch as tt
from tamp_tpu import Compressor
from tamp_tpu.exceptions import ExcessBitsError as JExcessBitsError
from tamp_tpu.exceptions import OutOfBoundsError as JOutOfBoundsError
from tamp_tpu_torch.ops import decode_serial

# (window, literal): every window once, every literal twice
CONFIGS = ((8, 5), (9, 6), (10, 7), (11, 8), (12, 5), (13, 6), (14, 7),
           (15, 8))
VARIANTS = (
    {},
    {"lazy_matching": True},
    {"extended": False},
    {"extended": False, "lazy_matching": True},
)
LENGTHS = (0, 1, 31, 32, 33, 3000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain kernels run many small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(n: int, literal: int = 8, seed: int = 1) -> bytes:
    """Seeded word text of ``n`` bytes, masked to the literal width."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 8)).astype(np.uint8)
             .tobytes() for _ in range(60)]
    text = b" ".join(words[i] for i in rng.integers(0, 60, n // 2 + 8))[:n]
    mask = (1 << literal) - 1
    return bytes(b & mask for b in text)


def _custom(window: int, literal: int) -> bytes:
    return (_text(1 << window, literal, seed=9) * 2)[: 1 << window]


def _outcome(fn):
    """(exception class name with the package stripped, or "ok", bytes)."""
    try:
        return "ok", bytes(fn())
    except (ValueError, JExcessBitsError, tt.ExcessBitsError) as e:
        return type(e).__name__, b""


def _same(kw: dict, data: bytes):
    want = tamp_tpu.compress(data, **kw)
    got = tt.compress(data, device="cpu", **kw)
    assert isinstance(got, bytes) and got == want, kw
    back = tt.decompress(got, dictionary=kw.get("dictionary"), device="cpu")
    assert isinstance(back, bytearray)
    assert back == tamp_tpu.decompress(want, dictionary=kw.get("dictionary"))
    assert back == data


@pytest.mark.parametrize("window,literal", CONFIGS)
def test_compress_equals_jax_across_configs(window, literal):
    # 200 bytes: one padded row of 512 positions, the smallest the
    # pipelines use, so window 15's plain tables stay quick
    data = _text(200, literal)
    for kw in VARIANTS:
        _same(dict(kw, window=window, literal=literal), data)


@pytest.mark.parametrize("n", LENGTHS)
def test_compress_equals_jax_across_lengths(n):
    data = _text(n)
    for kw in VARIANTS:
        _same(kw, data)


@pytest.mark.parametrize("window,literal", ((8, 6), (10, 8)))
@pytest.mark.parametrize("n", (33, 3000))
def test_compress_custom_dictionary(window, literal, n):
    data = _text(n, literal)
    d = _custom(window, literal)
    for kw in VARIANTS + ({"parse": "optimal"},
                          {"parse": "optimal", "extended": False}):
        _same(dict(kw, window=window, literal=literal, dictionary=d), data)
    # a bytearray dictionary is taken as bytes
    assert tt.compress(data, window=window, literal=literal,
                       dictionary=bytearray(d), device="cpu") \
        == tamp_tpu.compress(data, window=window, literal=literal,
                             dictionary=d)


@pytest.mark.parametrize("extended", [True, False])
@pytest.mark.parametrize("window,literal", ((8, 5), (10, 8), (12, 6)))
def test_optimal_equals_jax(extended, window, literal):
    for n in (0, 1, 33, 3000):
        data = _text(n, literal)
        kw = dict(window=window, literal=literal, extended=extended,
                  parse="optimal")
        _same(kw, data)
        # lazy matching is dropped, as tamp_tpu.compress drops it
        assert tt.compress(data, lazy_matching=True, device="cpu", **kw) \
            == tamp_tpu.compress(data, **kw)


def test_decompress_flushed_streams():
    # streams of the JAX package's streaming compressor: FLUSH tokens
    # mid-stream, the trailing partial byte padded
    text = _text(4000)
    for kw in ({}, {"window": 8, "literal": 7, "extended": False}):
        data = bytes(b & ((1 << kw.get("literal", 8)) - 1) for b in text)
        f = io.BytesIO()
        c = Compressor(f, **kw)
        for i in range(0, len(data), 700):
            c.write(data[i : i + 700])
            c.flush(write_token=True)
        c.close()
        blob = f.getvalue()
        assert tt.decompress(blob, device="cpu") \
            == tamp_tpu.decompress(blob) == data


def _rle_stream(tokens: int) -> bytes:
    """A w10 l8 extended stream: one literal, then ``tokens`` RLE tokens of
    225 bytes in 19 bits each (second symbol 13, trail 15), the most bytes
    a bit any token decodes to."""
    bits = "1" + format(ord("z"), "08b")
    rle = "0" + format(0xAA, "08b") + format(0x27, "06b") + "1111"
    bits += rle * tokens
    bits += "0" * (-len(bits) % 8)
    head = bytes([((10 - 8) << 5) | ((8 - 5) << 3) | 0b10])
    return head + int(bits, 2).to_bytes(len(bits) // 8, "big")


def test_rle_heavy_streams_decode_whole_on_the_retry_path(monkeypatch):
    calls = []
    real = decode_serial.serial_decode

    def spy(*args, **kw):
        calls.append(kw["max_out"])
        return real(*args, **kw)

    monkeypatch.setattr(decode_serial, "serial_decode", spy)
    # the reference encoder's densest stream (~92x) and a hand-built one of
    # the densest tokens (~94.7x: 225 bytes in 19 bits, the most the
    # format allows; no stream reaches 100x)
    for blob, raw in ((tamp_tpu.compress(b"q" * 300_000), b"q" * 300_000),
                      (_rle_stream(2000), b"z" * (1 + 225 * 2000))):
        calls.clear()
        got = tt.decompress(blob, device="cpu")
        assert got == tamp_tpu.decompress(blob) == raw
        assert len(raw) / len(blob) > 90
        # 8x the payload is cut, 32x is cut, then the stream's bound
        assert len(calls) == 3 and calls[0] < len(raw) and \
            calls[-1] == decode_serial.BYTES_PER_BIT * 8 * (len(blob) - 1) + 1


def test_decode_limit_raises(monkeypatch):
    monkeypatch.setattr(decode_serial, "MAX_DECODED", 50_000)
    blob = tamp_tpu.compress(b"q" * 60_000)
    with pytest.raises(ValueError, match="50000 bytes"):
        tt.decompress(blob, device="cpu")
    assert tt.decompress(tamp_tpu.compress(b"q" * 40_000),
                         device="cpu") == b"q" * 40_000


def test_stream_limits_raise(monkeypatch):
    assert tt.MAX_STREAM_BYTES == 1 << 27
    monkeypatch.setattr(tt, "MAX_STREAM_BYTES", 100)
    for kw in ({}, {"extended": False}, {"parse": "optimal"},
               {"parse": "optimal", "extended": False}):
        assert tt.compress(b"a" * 100, device="cpu", **kw) \
            == tamp_tpu.compress(b"a" * 100, **kw)
        with pytest.raises(ValueError, match="limited to 100 bytes"):
            tt.compress(b"a" * 101, device="cpu", **kw)


def test_error_classes_equal_jax():
    cases = [
        (b"hello", {"window": 7}), (b"hello", {"window": 16}),
        (b"hello", {"literal": 4}), (b"hello", {"literal": 9}),
        (b"hello\xff", {"literal": 7}),
        (b"\x80" * 40, {"literal": 7}),
        (b"ab" * 40 + b"\x40", {"literal": 6}),
        (b"hello", {"dictionary": b"abc"}),
        (b"hello", {"dictionary": b"a" * 2048}),
    ]
    for data, kw in cases:
        for extra in VARIANTS + ({"parse": "optimal"},
                                 {"parse": "optimal", "extended": False}):
            k = dict(kw, **extra)
            want = _outcome(lambda: tamp_tpu.compress(data, **k))
            got = _outcome(lambda: tt.compress(data, device="cpu", **k))
            assert got == want and want[0] != "ok", (data, k)
    with pytest.raises(ValueError, match="parse"):
        tt.compress(b"x", parse="lazy", device="cpu")


def test_decode_errors_equal_jax():
    data = _text(2000)
    good = tamp_tpu.compress(data)
    d = _custom(10, 8)
    custom = tamp_tpu.compress(data, dictionary=d)
    # a match at ring index 1020 of 10 bytes: past the window's end
    bits = "0" + "100110" + format(1020, "010b")
    bits += "0" * (-len(bits) % 8)
    oob = bytes([0x5A]) + int(bits, 2).to_bytes(len(bits) // 8, "big")
    with pytest.raises(JOutOfBoundsError):
        tamp_tpu.decompress(oob)
    with pytest.raises(tt.OutOfBoundsError):
        tt.decompress(oob, device="cpu")
    assert issubclass(tt.OutOfBoundsError, ValueError)
    streams = [b"", bytes([0x5B]), bytes([0x5B, 1]) + good[1:], good[:1],
               custom, custom[:100]]
    streams += [good[:k] for k in (2, 3, 17, len(good) // 2, len(good) - 1)]
    rng = np.random.default_rng(3)
    streams += [rng.integers(0, 256, int(rng.integers(1, 300)))
                .astype(np.uint8).tobytes() for _ in range(200)]
    kinds = set()
    for s in streams:
        for dic in (None, d, d[:100], d + b"tail"):
            want = _outcome(lambda: tamp_tpu.decompress(s, dictionary=dic))
            got = _outcome(lambda: tt.decompress(s, dictionary=dic,
                                                 device="cpu"))
            assert got == want, (s[:16].hex(), dic is None)
            kinds.add(want[0])
    assert kinds == {"ok", "ValueError", "OutOfBoundsError"}


def test_exports():
    for name in ("initialize_dictionary", "compute_min_pattern_size",
                 "bit_size"):
        assert getattr(tt, name)
    for size, literal in ((1024, 8), (256, 5), (1000, 6)):
        assert tt.initialize_dictionary(size, literal=literal) \
            == tamp_tpu.initialize_dictionary(size, literal=literal)
    buf = bytearray(b"x" * 64)
    assert tt.initialize_dictionary(buf) is buf
    assert tt.initialize_dictionary(8, seed=0) == bytearray(8)
    for v in (0, 1, 255, 256, (1 << 31), (1 << 32)):
        assert tt.bit_size(v) == tamp_tpu.bit_size(v)
    assert tt.compute_min_pattern_size(11, 6) \
        == tamp_tpu.compute_min_pattern_size(11, 6)


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.compress(b"x")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.compress(b"x", parse="optimal", extended=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.decompress(tamp_tpu.compress(b"x"))

"""The port's streaming codec (host code in both packages):
``tamp_tpu_torch.open``, ``Compressor`` / ``Decompressor`` and their
``Text*`` forms (the Python codec's copy), and the C++ streams
``tamp_tpu_torch.stream.NativeCompressor`` / ``NativeDecompressor`` with
their progress callbacks, held byte for byte against ``tamp_tpu.open(...,
implementation="python")`` and ``"native"``: extended and v1, lazy and
not, windows 8, 10 and 15, literals 5 and 8, a custom dictionary; writes
of 1, 7 and 4096 bytes, flushes with and without a token mid-stream,
``reset_dictionary``, append mode, text modes, chunked reads, the errors
where the JAX package raises them; callback events rising monotonically,
and an abort resumed to the same bytes.  Cases from
tests/test_file_interface.py, test_native_stream.py and
test_stream_callbacks.py."""

import io
import random

import numpy as np
import pytest

import tamp_tpu
import tamp_tpu_torch as tt
from tamp_tpu import _native
from tamp_tpu_torch.exceptions import AbortedError
from tamp_tpu_torch.stream import NativeCompressor, NativeDecompressor

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="the JAX package's native engine")

IMPLS = ("python", "native")


def _text(n: int, seed: int) -> bytes:
    """Seeded word text of ``n`` bytes with a run in the middle."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8)
             .tobytes() for _ in range(64)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 64, n // 4))
    return (text[: n // 2] + b"#" * 260 + text[n // 2 :])[:n]


def _write(module, impl, ops, **kw) -> bytes:
    """The stream ``module.open(..., "wb", implementation=impl, **kw)``
    writes for ``ops``: ("write", bytes, chunk), ("flush", write_token) or
    ("reset", None)."""
    buf = io.BytesIO()
    c = module.open(buf, "wb", implementation=impl, **kw)
    for op, arg, *chunk in ops:
        if op == "write":
            step = chunk[0]
            for i in range(0, len(arg), step):
                c.write(arg[i : i + step])
        elif op == "flush":
            c.flush(write_token=arg)
        else:
            c.reset_dictionary()
    c.close()
    return buf.getvalue()


# (extended, lazy, window, literal): every header combination, each window
# and literal width
CONFIGS = [(True, False, 10, 8), (True, True, 8, 5), (False, False, 15, 8),
           (False, True, 10, 5), (True, False, 15, 5), (False, False, 8, 8)]


@pytest.mark.parametrize("extended,lazy,window,literal", CONFIGS)
def test_streams_equal_jax_over_chunkings_and_flushes(extended, lazy, window,
                                                      literal):
    mask = (1 << literal) - 1
    data = bytes(b & mask for b in _text(6000, window))
    kw = dict(window=window, literal=literal, extended=extended,
              lazy_matching=lazy)
    for ops in ([("write", data, 4096)],
                [("write", data[:1500], 7), ("flush", False),
                 ("write", data[1500:], 4096)],
                [("write", data[:300], 1), ("flush", True),
                 ("write", data[300:], 7)]):
        want = _write(tamp_tpu, "python", ops, **kw)
        assert _write(tamp_tpu, "native", ops, **kw) == want
        for impl in IMPLS:
            assert _write(tt, impl, ops, **kw) == want, (impl, ops[0][2])
        if ("flush", False) in ops:
            continue  # a token-less flush mid-stream leaves bare padding
        joined = b"".join(a for op, a, *_ in ops if op == "write")
        for impl in IMPLS:
            with tt.open(io.BytesIO(want), "rb", implementation=impl) as d:
                assert bytes(d.read()) == joined


def test_random_operations_with_resets_equal_jax():
    rng = random.Random(16)
    for extended, lazy, window, literal in CONFIGS[:3]:
        mask = (1 << literal) - 1
        kw = dict(window=window, literal=literal, extended=extended,
                  lazy_matching=lazy, dictionary_reset=True)
        ops = []
        for _ in range(10):
            r = rng.random()
            if r < 0.7:
                n = rng.randrange(0, 400)
                data = (bytes(rng.getrandbits(8) for _ in range(n))
                        if rng.random() < 0.3 else
                        bytes(rng.choice(b"tampa bay ") for _ in range(n)))
                ops.append(("write", bytes(b & mask for b in data),
                            rng.choice((1, 7, 4096))))
            elif r < 0.85:
                ops.append(("flush", rng.random() < 0.7))
            else:
                ops.append(("reset", None))
        want = _write(tamp_tpu, "native", ops, **kw)
        assert _write(tamp_tpu, "python", ops, **kw) == want
        for impl in IMPLS:
            assert _write(tt, impl, ops, **kw) == want, (impl, ops)
            with tt.open(io.BytesIO(want), "rb", implementation=impl) as d:
                assert bytes(d.read()) == bytes(tamp_tpu.decompress(want))


@pytest.mark.parametrize("impl", IMPLS)
def test_custom_dictionary_and_append_mode(impl):
    d = bytes((b"lorem ipsum dolor sit amet " * 40)[:1024])
    data = b"lorem ipsum dolor sit consectetur " * 20
    # the Python codec writes into the window it is given: a fresh copy each
    want = _write(tamp_tpu, impl, [("write", data, 7)],
                  dictionary=bytearray(d))
    assert _write(tt, impl, [("write", data, 7)],
                  dictionary=bytearray(d)) == want
    back = tt.open(io.BytesIO(want), "rb", implementation=impl,
                   dictionary=bytearray(d))
    assert bytes(back.read()) == data
    # append mode: a stream ending on FLUSH, then an appended one
    first, second = b"part one. " * 30, b"part two, appended. " * 30
    outs = []
    for module in (tamp_tpu, tt):
        out = io.BytesIO()
        c = module.open(out, "wb", implementation=impl,
                        dictionary_reset=True)
        c.write(first)
        c.close()
        c = module.open(out, "wb", implementation=impl,
                        dictionary_reset=True, append=True)
        c.write(second)
        c.close()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert bytes(tt.open(io.BytesIO(outs[1]), "rb").read()) == first + second


def test_text_modes_paths_and_partial_reads(tmp_path):
    text = "héllo wörld! " * 50
    for module in (tamp_tpu, tt):
        p = tmp_path / f"{module.__name__}.tamp"
        with module.open(p, "w") as f:
            f.write(text)
        with tt.open(p, "r") as f:
            assert f.read() == text
    assert (tmp_path / "tamp_tpu.tamp").read_bytes() == \
        (tmp_path / "tamp_tpu_torch.tamp").read_bytes()
    data = b"the rain in spain stays mainly in the plain. " * 40
    p = tmp_path / "f.tamp"
    with tt.open(p, "wb", window=9) as f:
        f.write(data[:1000])
        f.write(data[1000:])
    assert p.read_bytes() == tamp_tpu.compress(data, window=9)
    for impl in IMPLS:
        with tt.open(p, "rb", implementation=impl) as f:
            first = bytes(f.read(100))
            buf = bytearray(333)
            n = f.readinto(buf)
            rest = bytes(f.read())
        assert first + bytes(buf[:n]) + rest == data
    with pytest.raises(ValueError):
        tt.open(io.BytesIO(), "rw")
    with pytest.raises(ValueError):
        tt.open(io.BytesIO(), "x")
    with pytest.raises(ValueError):
        tt.open(io.BytesIO(), "rb", implementation="cuda")


def test_dribbled_input_and_chunked_reads():
    rng = random.Random(3)
    data = bytes(rng.choice(b"the quick brown fox ") for _ in range(20000))
    blob = tamp_tpu.compress(data, window=9)

    class Dribble:
        def __init__(self, raw):
            self.raw, self.off = raw, 0

        def read(self, n):
            chunk = self.raw[self.off : self.off + rng.randrange(1, 97)]
            self.off += len(chunk)
            return chunk

    for impl in IMPLS:
        d = tt.open(Dribble(blob), "rb", implementation=impl)
        out = bytearray()
        while piece := d.read(rng.randrange(1, 777)):
            out += piece
        assert bytes(out) == data


def test_errors_where_jax_raises():
    # a byte wider than the literal
    for module in (tamp_tpu, tt):
        for impl in IMPLS:
            c = module.open(io.BytesIO(), "wb", implementation=impl,
                            literal=7)
            with pytest.raises(module.ExcessBitsError):
                c.write(b"\xff")
                c.flush()
    # a w8 v1 match at slot 255 of size 2 reads past the window: the native
    # decoders raise, the Python ones read it modulo the window
    oob = bytes([0x18, 0x3F, 0xC0])
    with pytest.raises(tamp_tpu.OutOfBoundsError):
        tamp_tpu.open(io.BytesIO(oob), "rb", implementation="native").read()
    with pytest.raises(tt.OutOfBoundsError):
        tt.open(io.BytesIO(oob), "rb", implementation="native").read()
    assert bytes(tt.open(io.BytesIO(oob), "rb", implementation="python")
                 .read()) == bytes(tamp_tpu.open(
                     io.BytesIO(oob), "rb", implementation="python").read())
    # a custom-dictionary stream without its dictionary, a bad window
    custom = tamp_tpu.compress(b"abc" * 10, dictionary=bytes(1024))
    for impl in IMPLS:
        with pytest.raises(ValueError):
            tt.open(io.BytesIO(custom), "rb", implementation=impl)
        with pytest.raises(ValueError):
            tt.open(io.BytesIO(), "wb", implementation=impl, window=16)
    with pytest.raises(ValueError):
        tt.Compressor(io.BytesIO()).reset_dictionary()


def test_large_incompressible_write_is_not_duplicated():
    data = np.random.default_rng(7).integers(0, 256, 150000,
                                             dtype=np.uint8).tobytes()
    out = io.BytesIO()
    with NativeCompressor(out) as c:
        c.write(data)
    assert out.getvalue() == tamp_tpu.compress(data)
    assert bytes(NativeDecompressor(out.getvalue()).read()) == data


def _native_compress(data, cb=None, **kw):
    buf = io.BytesIO()
    c = NativeCompressor(buf, **kw)
    if cb is not None:
        c.set_progress_callback(cb)
    c.write(data)
    c.close()
    return buf.getvalue()


def test_callback_events_rise_and_leave_the_stream_unchanged():
    data = _text(200000, 9)
    events = []
    blob = _native_compress(data, cb=lambda bi, bo: events.append((bi, bo)))
    assert events and all(b >= a for a, b in zip(events, events[1:]))
    assert 0 < events[-1][0] <= len(data)
    assert 0 < events[-1][1] <= len(blob)
    assert blob == tamp_tpu.compress(data)
    events = []
    d = NativeDecompressor(blob)
    d.set_progress_callback(lambda bi, bo: events.append((bi, bo)))
    assert bytes(d.read()) == data
    assert events and all(b >= a for a, b in zip(events, events[1:]))
    assert events[-1][0] <= len(blob) and events[-1][1] <= len(data)
    # the flush drain polls too: tiny writes hold all their input
    events = []
    c = NativeCompressor(io.BytesIO())
    c.set_progress_callback(lambda bi, bo: events.append((bi, bo)))
    for i in range(0, 8192, 13):
        c.write(data[i : i + 13])
    c.close()
    assert events and events[-1][0] <= 8192


def test_abort_then_resume_gives_the_same_bytes():
    data = _text(200000, 10)
    want = tamp_tpu.compress(data)
    buf = io.BytesIO()
    c = NativeCompressor(buf)
    calls = [0]

    def aborter(bi, bo):
        calls[0] += 1
        return calls[0] >= 2

    c.set_progress_callback(aborter)
    with pytest.raises(AbortedError):
        c.write(data)
    assert calls[0] == 2
    c.set_progress_callback(None)
    c.write(b"")  # resume: the rest of the input is held in the stream
    c.close()
    assert buf.getvalue() == want
    # the decoder: an abort keeps what it decoded, a resumed read the rest
    d = NativeDecompressor(want)
    d.set_progress_callback(lambda bi, bo: True)
    got = bytearray(len(data))
    with pytest.raises(AbortedError):
        d.readinto(got)
    d.set_progress_callback(None)
    rest = d.read()
    k = len(data) - len(rest)
    assert 0 < k < len(data)
    assert bytes(got[:k]) + bytes(rest) == data
    # an exception in the callback comes out of the call; the stream lives
    d = NativeDecompressor(want)

    def boom(bi, bo):
        raise KeyError("boom")

    d.set_progress_callback(boom)
    with pytest.raises(KeyError):
        d.read()
    d.set_progress_callback(None)
    rest = d.read()
    assert data.endswith(bytes(rest)) and len(rest) > 0

"""The port's token-serial decoder (ops/decode_serial.py, kernel X2's plain
version) against the JAX package's ``decode_shards_device`` on the cases of
tests/test_device_decode.py and on the seeded hazard streams that the card
tests hold kernel X2 to (``x2_hazard_streams`` of tests/test_torch_cuda.py),
and against the native decoder where ``decode_jax`` departs from the
reference decoder.  Exact equality."""

import io
import random

import numpy as np
import pytest
import torch

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu._native.stream import NativeCompressor
from tamp_tpu.ops.decode_jax import decode_shards_device as jax_decode
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops.decode_serial import (
    decode_shards_device, serial_decode,
)
from tamp_tpu_torch.parallel import shard as tshard
from test_torch_cuda import X2_HAZARD_KINDS, x2_hazard_streams

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


def _gen(rng, n, style):
    if style == 0:
        return bytes(rng.getrandbits(8) for _ in range(n))
    if style == 1:
        return bytes(rng.choice(b"hello world ") for _ in range(n))
    if style == 2:
        return bytes([7]) * n
    return (b"abcdefgh" * (n // 8 + 1))[:n]


@pytest.mark.parametrize("w,lit,ext", [
    (10, 8, True), (8, 8, False), (12, 7, True), (9, 5, True),
])
def test_serial_matches_jax(w, lit, ext):
    rng = random.Random(w * 16 + lit)
    mask = (1 << lit) - 1
    datas = [bytes(b & mask for b in _gen(rng, rng.randrange(50, 1500),
                                          s % 4)) for s in range(6)]
    shards = [bytes(_native.native_compress(d, window=w, literal=lit,
                                            extended=ext)) for d in datas]
    got = decode_shards_device(shards, max_out=1500, device="cpu")
    assert got == datas
    assert got == jax_decode(shards, max_out=1500)
    # the decode stops at max_out and cuts the output there, with no error
    cut = decode_shards_device(shards, max_out=600, device="cpu")
    assert cut == jax_decode(shards, max_out=600)
    assert cut == [d[:600] for d in datas]


def test_serial_flush_and_reset_matches_jax():
    out = io.BytesIO()
    c = NativeCompressor(out, dictionary_reset=True)
    c.write(b"first segment " * 20)
    c.flush()
    c.write(b"second segment " * 20)
    c.reset_dictionary()
    c.write(b"third segment " * 20)
    c.close()
    blob = out.getvalue()
    want = bytes(tamp_tpu.decompress(blob))
    got = decode_shards_device([blob], max_out=4096, device="cpu")
    assert got == [want] == jax_decode([blob], max_out=4096)


def test_serial_custom_dictionary_matches_jax():
    d = bytes((b"shared dictionary content " * 64)[:1024])
    data = b"shared dictionary content is reused here"
    blob = bytes(_native.native_compress(data, dictionary=d))
    got = decode_shards_device([blob], dictionary=d, max_out=256,
                               device="cpu")
    assert got == [data] == jax_decode([blob], dictionary=d, max_out=256)


def test_serial_custom_dictionary_reset_follows_native():
    # decode_jax reloads the custom dictionary on a double FLUSH; the
    # native decoder (and this port) loads the default one
    rng = np.random.default_rng(4)
    custom = bytes(rng.integers(97, 110, 1024).astype(np.uint8))
    f = io.BytesIO()
    c = NativeCompressor(f, window=10, literal=8, extended=True,
                         dictionary=bytearray(custom), dictionary_reset=True)
    c.write(custom[:300] + b" first")
    c.reset_dictionary()
    c.write(b"second part, default window " * 4 + custom[500:600])
    c.flush(write_token=False)
    stream = f.getvalue()
    want = bytes(_native.native_decompress(stream, dictionary=custom))
    got = decode_shards_device([stream], dictionary=custom, max_out=4096,
                               device="cpu")
    assert got == [want]
    assert jax_decode([stream], dictionary=custom, max_out=4096) != [want]
    # an oversized custom dictionary: its first W bytes are the window
    big = custom + bytes(rng.integers(0, 256, 512).astype(np.uint8))
    assert decode_shards_device([stream], dictionary=big, max_out=4096,
                                device="cpu") == [want]
    with pytest.raises(ValueError):
        decode_shards_device([stream], dictionary=custom[:1000],
                             max_out=4096, device="cpu")


def test_serial_errors_raise_value_error():
    bad = bytearray(tamp_tpu.compress(b"zqx" * 400, window=10, literal=8))
    bad[len(bad) // 2] ^= 0x5A
    with pytest.raises(ValueError):
        _native.native_decompress(bytes(bad))
    with pytest.raises(ValueError):
        decode_shards_device([bytes(bad)], max_out=4096, device="cpu")
    with pytest.raises(ValueError):
        jax_decode([bytes(bad)], max_out=4096)
    # truncated streams end quietly, as both references do
    good = tamp_tpu.compress(b"truncate me please " * 30, window=10)
    for cut in (3, len(good) // 2, len(good) - 1):
        want = bytes(_native.native_decompress(good[:cut]))
        assert decode_shards_device([good[:cut]], max_out=4096,
                                    device="cpu") == [want]


def test_serial_decode_wrapper_checks_its_input():
    d = torch.from_numpy(dictionary_array(1024))
    pl = torch.zeros((1, 8), dtype=torch.uint8)
    nb = torch.tensor([8], dtype=torch.int32)
    kw = dict(window=10, literal=8, extended=True, more=False, max_out=64)
    with pytest.raises(ValueError):
        serial_decode(pl.to(torch.int32), nb, d, d, **kw)
    with pytest.raises(ValueError):
        serial_decode(pl, nb, d[:512], d, **kw)
    out, lens, errs = serial_decode(pl, nb, d, d, **kw)
    assert out.shape == (1, 64) and errs.tolist() == [0]


def test_serial_container_round_trip():
    rng = random.Random(5)
    data = bytes(rng.choice(b"tampa bay buccaneers ") for _ in range(30000))
    for blob in (tshard.compress_sharded(data, shard_size=4096, device="cpu",
                                         engine="device-commit"),
                 jshard.compress_sharded(data, shard_size=4096,
                                         engine="native")):
        got = tshard.decompress_sharded_device(blob, algorithm="serial",
                                               device="cpu")
        assert bytes(got) == data


@pytest.mark.parametrize("kind", X2_HAZARD_KINDS)
@pytest.mark.parametrize("window", [8, 10, 15])
def test_serial_matches_jax_on_hazard_streams(window, kind):
    # matches into the last ring bytes, RLE and extended matches at the
    # ring end, double FLUSH, a match past the window, a trailing
    # incomplete token, and max_out inside a match or an RLE of 9+ bytes
    streams, lens, _more, max_out = x2_hazard_streams(window, kind)
    if kind.startswith("out of"):  # both decoders refuse the stream
        with pytest.raises(ValueError):
            decode_shards_device(streams, max_out=max_out, device="cpu")
        with pytest.raises(ValueError):
            jax_decode(streams, max_out=max_out)
        return
    got = decode_shards_device(streams, max_out=max_out, device="cpu")
    assert got == jax_decode(streams, max_out=max_out)
    if kind != "trailing incomplete token":
        assert [len(x) for x in got] == [min(n, max_out) for n in lens]
    if kind.startswith("max_out"):
        full = decode_shards_device(streams, max_out=1 << 17, device="cpu")
        assert got == [x[:max_out] for x in full]

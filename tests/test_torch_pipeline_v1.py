"""Whole v1 streams of the port (engine/pipeline.py, plain versions on the
CPU) against the JAX package's device-commit v1 encode (interpret mode) and
the native encoder (``extended=False``), lazy matching on and off."""

import numpy as np
import pytest

from tamp_tpu import _native
from tamp_tpu.engine.pipeline import encode_v1_device_commit as jax_enc
from tamp_tpu_torch import ExcessBitsError
from tamp_tpu_torch.engine.pipeline import encode_v1_device_commit

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


def _text(n: int, seed: int, lmask: int = 255) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 112, rng.integers(1, 9)))
             for _ in range(56)]
    s = bytearray(b" ".join(words[int(i)] for i in rng.integers(0, 56, n)))
    s = s[:n]
    s[n // 3 : n // 3 + 100] = b"x" * 100
    return bytes(b & lmask for b in s)


def _shards(seed: int, lmask: int, n: int):
    rng = np.random.default_rng(seed)
    text = _text(n, seed, lmask)
    noise = bytes(int(x) & lmask for x in rng.integers(0, 256, n // 2))
    runs = b"".join(bytes([int(rng.integers(0, 6)) & lmask]) * int(c)
                    for c in rng.integers(1, 200, 12))[:n]
    return [text, noise, runs, b"", text[:1], text[:15], text[:16],
            text[:17]]


def _native_v1(s: bytes, window: int, literal: int, lazy: bool,
               dictionary=None) -> bytes:
    return bytes(_native.native_compress(
        s, window=window, literal=literal, extended=False,
        lazy_matching=lazy, dictionary=dictionary))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("window,literal", [
    (8, 8), (9, 5), (10, 8), (11, 5), (12, 7), (15, 8)])
def test_streams_match_jax_and_native(window, literal, lazy):
    n = 1500 if window <= 12 else 300  # the plain tables cost O(W) each
    shards = _shards(window * 10 + literal, (1 << literal) - 1, n)
    got = encode_v1_device_commit(shards, window=window, literal=literal,
                                  lazy_matching=lazy, device="cpu")
    want = jax_enc(shards, window=window, literal=literal,
                   lazy_matching=lazy, interpret=True)
    assert got == want
    for s, b in zip(shards, got):
        assert b == _native_v1(s, window, literal, lazy)
        assert bytes(_native.native_decompress(b)) == s


def test_lazy_cache_crosses_into_the_host_tail():
    # these shards end the lazy kernel walk with a deferred match cached
    # (tests/test_torch_encode_commit_v1.py): the host tail takes it first
    shards = [_text(363, 49), _text(601, 83)]
    got = encode_v1_device_commit(shards, lazy_matching=True, device="cpu")
    for s, b in zip(shards, got):
        assert b == _native_v1(s, 10, 8, True)


@pytest.mark.parametrize("lazy", [False, True])
def test_custom_dictionary(lazy):
    rng = np.random.default_rng(7)
    dictionary = bytes(rng.integers(97, 110, 1024).astype(np.uint8))
    shards = [dictionary[100:900] + b"tail bytes", b"", dictionary[:20]]
    got = encode_v1_device_commit(shards, lazy_matching=lazy,
                                  dictionary=dictionary, device="cpu")
    assert got == jax_enc(shards, lazy_matching=lazy, dictionary=dictionary,
                          interpret=True)
    for s, b in zip(shards, got):
        assert b == _native_v1(s, 10, 8, lazy, dictionary)
        assert bytes(_native.native_decompress(b, dictionary=dictionary)) \
            == s
    with pytest.raises(ValueError):
        encode_v1_device_commit([b"a"], dictionary=b"x" * 512, device="cpu")


@pytest.mark.parametrize("lazy", [False, True])
def test_excess_bits_literal7(lazy):
    # in the kernel walk, and among the last < 16 bytes (the host tail)
    for shards in ([b"plain ascii " * 5, b"ok \x80 not" * 5],
                   [b"x" * 40 + b"\xff"]):
        with pytest.raises(ExcessBitsError):
            encode_v1_device_commit(shards, window=10, literal=7,
                                    lazy_matching=lazy, device="cpu")
    assert encode_v1_device_commit([], device="cpu") == []

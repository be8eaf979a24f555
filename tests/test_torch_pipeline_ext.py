"""Whole extended streams of the port (engine/pipeline_ext.py, plain
versions on the CPU) against the JAX package: its device-commit encode with
interpret-mode kernels and the native planned committer, lazy matching on
and off."""

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu.engine.pipeline_ext import encode_ext_device_commit as jax_enc
from tamp_tpu.engine.search_np import MatchTables
from tamp_tpu_torch import ExcessBitsError
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.pipeline_ext import (
    encode_ext_device_commit, ext_fields, prepare_batch,
)
from tamp_tpu_torch.engine.tail import ext_tail_bits

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


def native_planned(raw: bytes, window: int, literal: int,
                   lazy: bool = False) -> bytes:
    """The native committer in forced-planned mode (__graft_entry__.py),
    with the probe tables under lazy matching
    (tests/test_encode_ext_device.py)."""
    arr = np.frombuffer(raw, np.uint8)
    plans, khat, dh, _rc = _native.native_ext_prep(arr, window)
    tabs = _native.native_v1_tables(dh, window, literal, 16, ext_dict=True,
                                    probe=lazy)
    rows = np.minimum(khat[:-1].astype(np.int64),
                      max(0, dh.shape[0] - 1)).astype(np.int64)
    l16, i16, *probe = (t[rows] for t in tabs)
    g = MatchTables(l16, i16, l16, i16, *probe)
    return _native.native_compress(
        arr.tobytes(), window=window, literal=literal, extended=True,
        lazy_matching=lazy, tables=g, avoid_divergence=True, khat=khat,
        plan=plans, force_planned=True)


def _shards(seed: int, lmask: int):
    rng = np.random.default_rng(seed)
    words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
             for k in rng.integers(2, 9, 48)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 48, 300))
    runs = b"".join(bytes([int(rng.integers(0, 6)) & lmask]) * int(c)
                    for c in rng.integers(1, 300, 8))
    period = bytes(int(x) & lmask for x in rng.integers(0, 256, 13)) * 60
    shards = [text[:1300], runs[:1100] + text[:200], period[:700], b"", b"x",
              text[:15], text[:16]]
    return [bytes(b & lmask for b in s) for s in shards]


@pytest.mark.parametrize("window,literal", [
    (8, 8), (9, 5), (10, 8), (11, 7), (12, 6), (13, 8), (15, 8)])
def test_streams_match_jax_and_native(window, literal):
    shards = _shards(window * 10 + literal, (1 << literal) - 1)
    if window >= 13:  # the plain tables cost O(W) per position
        shards = [s[:500] for s in shards]
    got = encode_ext_device_commit(shards, window=window, literal=literal,
                                   device="cpu")
    want = jax_enc(shards, window=window, literal=literal, interpret=True)
    assert got == want
    for s, b in zip(shards, got):
        assert b == native_planned(s, window, literal)
        assert bytes(_native.native_decompress(b)) == s


def test_custom_dictionary_matches_jax():
    rng = np.random.default_rng(7)
    dictionary = bytes(rng.integers(97, 110, 1024).astype(np.uint8))
    shards = [dictionary[100:900] + b"tail bytes", b"", dictionary[:20]]
    got = encode_ext_device_commit(shards, window=10, literal=8,
                                   dictionary=dictionary, device="cpu")
    assert got == jax_enc(shards, window=10, literal=8,
                          dictionary=dictionary, interpret=True)
    for s, b in zip(shards, got):
        assert bytes(_native.native_decompress(b, dictionary=dictionary)) == s
    with pytest.raises(ValueError):
        encode_ext_device_commit([b"a"], window=10, dictionary=b"x" * 512,
                                 device="cpu")


def test_excess_bits_literal7():
    with pytest.raises(ExcessBitsError):
        encode_ext_device_commit([b"plain ascii", b"ok \x80 not"],
                                 window=10, literal=7, device="cpu")
    # a 0x80+ byte among the last < 16 bytes reaches the host tail walk
    with pytest.raises(ExcessBitsError):
        encode_ext_device_commit([b"x" * 40 + b"\xff"], window=10,
                                 literal=7, device="cpu")


def test_not_ported_options_raise():
    with pytest.raises(ValueError):
        encode_ext_device_commit([b"abc"], window=16, device="cpu")
    assert encode_ext_device_commit([], device="cpu") == []


@pytest.mark.parametrize("window,literal", [(8, 8), (10, 8), (11, 6),
                                            (14, 8)])
def test_lazy_streams_match_jax_and_native(window, literal):
    shards = _shards(window * 10 + literal + 1, (1 << literal) - 1)
    if window >= 13:
        shards = [s[:500] for s in shards]
    got = encode_ext_device_commit(shards, window=window, literal=literal,
                                   lazy_matching=True, device="cpu")
    want = jax_enc(shards, window=window, literal=literal,
                   lazy_matching=True, interpret=True)
    assert got == want
    for s, b in zip(shards, got):
        assert b == native_planned(s, window, literal, lazy=True)
        assert bytes(_native.native_decompress(b)) == s


def test_lazy_wins_on_text():
    # lazy matching exists to improve the parse: on text it strictly wins
    # (tests/test_encode_ext_device.py test_lazy_strictly_wins_on_text)
    text = _shards(31, 255)[0] * 4
    plain, = encode_ext_device_commit([text], device="cpu")
    lazy, = encode_ext_device_commit([text], lazy_matching=True,
                                     device="cpu")
    assert len(lazy) < len(plain)


def test_tail_is_the_same_under_lazy_matching():
    # the planned walk never defers with fewer than 16 bytes left, so the
    # port's one tail walk equals the native tail with lazy=True at every
    # walk entry of the lazy fields where the kernel may stop (the last 15
    # model positions)
    window, literal = 10, 8
    d = dictionary_array(1 << window, literal=literal)
    arrs = [np.frombuffer(s[:n], np.uint8) for s in _shards(5, 255)[:3]
            for n in range(600, 640, 6)]
    prep, dh, rc, npos = prepare_batch(arrs, window=window)
    tabs, _A, B = ext_fields(
        torch.from_numpy(dh), torch.from_numpy(rc), torch.from_numpy(npos),
        torch.from_numpy(d.copy()), window=window, literal=literal,
        lazy=True)
    tabs = [t.numpy() for t in tabs]
    for i, arr in enumerate(arrs):
        plans, khat, dhi, _ = prep[i]
        M = dhi.shape[0]
        b, t_m = B[i].tolist(), 0
        while t_m < M:
            if t_m >= M - 15:
                t_in = int(np.searchsorted(khat, t_m + 1)) - 1
                got = ext_tail_bits(
                    arr, t_in, dhi, khat, plans,
                    tuple(t[i, :M] for t in tabs), 0, window=window,
                    literal=literal, acc=0, an=0, dict_last=int(d[-1]))
                assert got == _native.native_ext_tail_bits(
                    arr, t_in, dhi, khat, plans, window=window,
                    literal=literal, acc=0, an=0, lazy=True)
            t_m += (b[t_m] >> 6) & 255

"""The port's host greedy committer (tamp_tpu_torch.engine.greedy) against
the JAX package's reference encoders, byte for byte.

Table-less, the committer is the reference greedy encoder: equal to
``tamp_tpu.compressor.compress`` (pure Python) and ``tamp_tpu.compress``
(the native engine) over text, runs, random and periodic data, windows
8-15, literals 5-8, lazy matching on and off.  With tables it must not
change a byte, whichever entries are holed (the sparse pull of the
greedy-parity encode rests on that)."""

import numpy as np
import pytest
import torch

import tamp_tpu
from tamp_tpu.compressor import compress as py_compress
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.greedy import SPARSE_NONE, greedy_compress
from tamp_tpu_torch.exceptions import ExcessBitsError
from tamp_tpu_torch.ops.match_v1 import v1_tables


def _gen(rng, kind: int, n: int, lmask: int) -> bytes:
    if kind == 0:  # run-heavy: long runs, RLE window-write truncations
        out, tot = [], 0
        while tot < n:
            c = int(rng.integers(1, 500))
            out.append(bytes([int(rng.integers(0, 6)) & lmask]) * c)
            tot += c
        return b"".join(out)[:n]
    if kind == 1:  # periodic: extended matches, ring-end truncations
        p = bytes(int(x) & lmask
                  for x in rng.integers(0, 256, int(rng.integers(2, 30))))
        return (p * (n // len(p) + 1))[:n]
    if kind == 2:  # text-ish: literals, short matches, short runs
        words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
                 for k in rng.integers(2, 9, 64)]
        return bytes([1 & lmask]).join(
            words[int(i)] for i in rng.integers(0, 64, n // 4))[:n]
    return bytes(int(x) & lmask for x in rng.integers(0, 256, n))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("window", [8, 10, 12, 15])
def test_table_less_equals_reference_encoders(window, lazy):
    rng = np.random.default_rng(window * 10 + lazy)
    for literal in (5, 6, 7, 8):
        lmask = (1 << literal) - 1
        for kind in range(4):
            data = _gen(rng, kind, 1200, lmask)
            kw = dict(window=window, literal=literal, lazy_matching=lazy)
            got = greedy_compress(data, **kw)
            assert got == py_compress(data, extended=True, **kw), \
                (literal, kind)
            assert got == tamp_tpu.compress(data, extended=True, **kw), \
                (literal, kind)


@pytest.mark.parametrize("lazy", [False, True])
def test_custom_dictionary_empty_and_short_inputs(lazy):
    rng = np.random.default_rng(3)
    dictionary = bytes(rng.integers(97, 123, 1 << 9).astype(np.uint8))
    data = dictionary[100:400] + _gen(rng, 2, 900, 255) + dictionary[:50]
    kw = dict(window=9, literal=8, lazy_matching=lazy)
    got = greedy_compress(data, dictionary=dictionary, **kw)
    assert got == py_compress(data, dictionary=bytearray(dictionary),
                              extended=True, **kw)
    assert got[0] & 4  # the header's custom-dictionary flag
    for data in (b"", b"a", b"abcabcab", b"z" * 15, b"hello hello wor"):
        assert greedy_compress(data, lazy_matching=lazy) == py_compress(
            data, extended=True, lazy_matching=lazy)
    with pytest.raises(ValueError):
        greedy_compress(b"abc", dictionary=b"x" * 100)


def test_excess_bits_at_literal_7():
    with pytest.raises(ExcessBitsError):
        greedy_compress(b"abc" * 30 + b"\xc3" + b"abc", literal=7)
    with pytest.raises(ExcessBitsError):
        greedy_compress(b"\x80" + b"abc" * 30, literal=7, lazy_matching=True)
    assert greedy_compress(b"abc" * 30, literal=7) == py_compress(
        b"abc" * 30, literal=7, extended=True)


@pytest.mark.parametrize("window,literal,lazy", [
    (10, 8, False), (10, 8, True), (12, 8, False), (11, 5, True)])
def test_holed_tables_do_not_change_a_byte(window, literal, lazy):
    """Full cap-16 tables from kernel B5's plain version, then 30, 90 and
    100 % of the entries holed: every stream equals the table-less one."""
    rng = np.random.default_rng(404 + window)
    lmask = (1 << literal) - 1
    data = (_gen(rng, 2, 1500, lmask) + bytes([7 & lmask]) * 30
            + _gen(rng, 1, 800, lmask) + _gen(rng, 0, 700, lmask))
    n = len(data)
    row = np.frombuffer(data, np.uint8)[None].copy()
    tabs = v1_tables(torch.from_numpy(row),
                     torch.tensor([n], dtype=torch.int32),
                     torch.from_numpy(dictionary_array(1 << window, literal)),
                     window_bits=window, cap=16, probe=lazy)
    tabs = [t[0].numpy().astype(np.uint8 if k % 2 == 0 else np.int32)
            for k, t in enumerate(tabs)]
    kw = dict(window=window, literal=literal, lazy_matching=lazy)
    want = greedy_compress(data, **kw)
    assert want == tamp_tpu.compress(data, extended=True, **kw)
    assert greedy_compress(data, tables=tabs, **kw) == want
    for frac in (0.3, 0.9, 1.0):
        hole = rng.random(n) < frac
        holed = [t.copy() for t in tabs]
        for k in range(0, len(holed), 2):
            holed[k][hole] = SPARSE_NONE
        assert greedy_compress(data, tables=holed, **kw) == want, frac


def test_malformed_tables_raise():
    data = b"abcabcabcabc" * 10
    n = len(data)
    ok = (np.full(n, SPARSE_NONE, np.uint8), np.zeros(n, np.int32))
    assert greedy_compress(data, tables=ok) == greedy_compress(data)
    with pytest.raises(ValueError):
        greedy_compress(data, tables=(ok[0], np.full(n, 1024, np.int32)))
    with pytest.raises(ValueError):
        greedy_compress(data, tables=(ok[0], np.full(n, -1, np.int32)))
    with pytest.raises(ValueError):
        greedy_compress(data, tables=(ok[0][:5], ok[1][:5]))
    with pytest.raises(ValueError):
        greedy_compress(data, tables=ok, lazy_matching=True)

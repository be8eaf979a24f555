"""The port's v1 commit inputs and kernel B6 (tamp_tpu_torch.ops.encode_commit)
against the JAX package: its ``plan_fields`` and its lazy stream-commit
kernel in interpret mode, on the same packed tables.  Integer planes, bytes
and state slots: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tamp_tpu.ops.encode_commit_pallas import encode_commit_batch, plan_fields
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops.encode_commit import (
    S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NBYTES, S_T, commit_v1_lazy,
    plan_fields_v1,
)
from tamp_tpu_torch.ops.encode_fused import v1_cap
from tamp_tpu_torch.ops.match_v1 import v1_tables


def _rows(n: int, seed: int, lmask: int = 255):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 112, rng.integers(1, 9)))
             for _ in range(56)]
    s = bytearray(b" ".join(words[int(i)] for i in rng.integers(0, 56, n)))
    s = s[:n]
    s[n // 3 : n // 3 + 100] = b"x" * 100
    return np.frombuffer(bytes(s), np.uint8) & lmask


def _packed(datas, window, literal, NP=2048):
    """The packed tables ``len << 23 | idx << 8 | byte`` and probe
    ``plen << 15 | pidx`` of a batch, from B5's plain version."""
    S = len(datas)
    data = np.zeros((S, NP), np.uint8)
    for i, d in enumerate(datas):
        data[i, : d.shape[0]] = d
    npos = torch.tensor([d.shape[0] for d in datas], dtype=torch.int32)
    data_t = torch.from_numpy(data)
    flen, fidx, plen, pidx = v1_tables(
        data_t, npos, torch.from_numpy(dictionary_array(1 << window, 8)),
        window_bits=window, cap=v1_cap(window, literal), probe=True)
    packed = (flen << 23) | (fidx << 8) | data_t.to(torch.int32)
    return packed, (plen << 15) | pidx, npos


@pytest.mark.parametrize("window,literal", [
    (8, 8), (10, 8), (11, 5), (12, 7), (15, 8)])
def test_plan_fields_v1_matches_jax(window, literal):
    lmask = (1 << literal) - 1
    datas = [_rows(1900, window, lmask), _rows(700, window + 1, lmask)]
    if literal == 7:
        datas[1][300] = 0xC3  # an excess-bits literal sets the error bit
    packed, _probe, _npos = _packed(datas, window, literal)
    A, B = plan_fields_v1(packed, window=window, literal=literal)
    JA, JB = plan_fields(jnp.asarray(packed.numpy()), window=window,
                         literal=literal)
    JA = np.asarray(JA)
    if JB is None:  # window <= 11: one word value << 11 | nb << 6 | adv << 1
        JB = ((JA >> 6) & 31) | (((JA >> 1) & 31) << 6) | ((JA & 1) << 14)
        JA = JA >> 11
    np.testing.assert_array_equal(A.numpy(), JA)
    np.testing.assert_array_equal(B.numpy(), np.asarray(JB))
    if literal == 7:
        assert (B.numpy() >> 14 & 1).any()


def _compare_lazy(datas, window, literal):
    packed, probe, npos = _packed(datas, window, literal)
    NP = packed.shape[1]
    max_out = NP + NP // 8 + 64
    out, st = commit_v1_lazy(packed, probe, npos, window=window,
                             literal=literal, max_out=max_out)
    jout, jst = encode_commit_batch(
        jnp.asarray(packed.numpy()), jnp.asarray(probe.numpy()),
        jnp.asarray(npos.numpy()), NP=NP, window=window, literal=literal,
        lazy=True, max_out=max_out, interpret=True)
    jout, jst, st = np.asarray(jout), np.asarray(jst), st.numpy()
    for s in range(len(datas)):
        for slot in (S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR):
            assert st[s, slot] == jst[s, slot], (s, slot)
        nb = int(st[s, S_NBYTES])
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
        assert int(out[s, nb:].abs().sum()) == 0
    return st


@pytest.mark.parametrize("window,literal", [(10, 8), (11, 5)])
def test_b6_plain_matches_pallas(window, literal):
    lmask = (1 << literal) - 1
    datas = [_rows(1900, window, lmask), _rows(900, window + 1, lmask),
             _rows(40, 3, lmask), np.zeros(0, np.uint8),
             np.full(17, 65 & lmask, np.uint8)]
    st = _compare_lazy(datas, window, literal)
    assert (st[:, S_ERR] == 0).all()


def test_b6_plain_excess_bits_row():
    # literal 7 and a 0x80+ byte: the walk flags ERR_EXCESS at that literal
    # and stops with t = npos; the clean row is unaffected
    good = _rows(1200, 5) & 0x7F
    bad = good.copy()
    bad[700] = 0xC3
    st = _compare_lazy([good, bad], 10, 7)
    assert st[0, S_ERR] == 0 and st[1, S_ERR] == 1
    assert st[1, S_T] == bad.shape[0]


def test_b6_leaves_its_lazy_cache_at_the_stop():
    # a deferral decided at npos - 16 stops the walk at npos - 15 with the
    # deferred match cached for the host tail (these two shards do that)
    datas = [_rows(363, 49), _rows(601, 83)]
    st = _compare_lazy(datas, 10, 8)
    assert (st[:, S_CIDX] >= 0).all()
    assert [int(x) for x in st[:, S_T]] == [363 - 15, 601 - 15]


def test_b6_plain_matches_pallas_on_random_tables():
    # any packed sizes, up to 16 where minp + 13 is 15 (the Huffman symbol
    # clips at 13, as in the TPU kernel), random probes and an excess byte
    rng = np.random.default_rng(2)
    S, NP = 3, 2048
    packed = ((rng.integers(0, 17, (S, NP)) << 23)
              | (rng.integers(0, 1024, (S, NP)) << 8)
              | rng.integers(0, 128, (S, NP)))
    probe = (rng.integers(0, 16, (S, NP)) << 15) | rng.integers(0, 1024,
                                                              (S, NP))
    packed[2, 1480:1520] = 0x41
    packed[2, 1500] = 0xC3
    probe[2, 1480:1520] = 0
    packed = torch.from_numpy(packed.astype(np.int32))
    probe = torch.from_numpy(probe.astype(np.int32))
    npos = torch.tensor([2048, 1000, 2000], dtype=torch.int32)
    kw = dict(window=10, literal=7, max_out=NP + NP // 8 + 64)
    out, st = commit_v1_lazy(packed, probe, npos, **kw)
    jout, jst = encode_commit_batch(
        jnp.asarray(packed.numpy()), jnp.asarray(probe.numpy()),
        jnp.asarray(npos.numpy()), NP=NP, lazy=True, interpret=True, **kw)
    jout, jst, st = np.asarray(jout), np.asarray(jst), st.numpy()
    np.testing.assert_array_equal(st[:, :7], jst[:, :7])
    for s in range(S):
        nb = int(st[s, S_NBYTES])
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
    assert st[:, S_ERR].tolist() == [0, 0, 1]

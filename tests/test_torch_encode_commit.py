"""Kernel B3's plain version (tamp_tpu_torch.ops.encode_commit) against the
JAX package's planned-fields commit kernel in interpret mode, on the same
planned fields.  Bytes and state slots: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tamp_tpu.ops.encode_commit_pallas import _commit_fields_batch
from tamp_tpu_torch.constants import compute_min_pattern_size
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.pipeline_ext import prepare_batch
from tamp_tpu_torch.ops.encode_commit import (
    S_ACC, S_AN, S_ERR, S_NBYTES, S_T, commit_fields,
)
from tamp_tpu_torch.ops.plan_ext import derive_region_arrays, plan_fields_ext
from tamp_tpu_torch.ops.match_ext import ext_tables


def _rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 112, rng.integers(1, 9)))
             for _ in range(56)]
    s = bytearray(b" ".join(words[int(i)] for i in rng.integers(0, 56, n)))
    s = s[:n]
    s[n // 3 : n // 3 + 300] = b"x" * 300
    s[n // 2 : n // 2 + 200] = s[100:300]  # an extended match
    return np.frombuffer(bytes(s), np.uint8)


def _fields(datas, window, literal):
    prep, dh, rc, npos = prepare_batch(datas, window=window)
    d = torch.from_numpy(dictionary_array(1 << window, literal=literal))
    dh_t = torch.from_numpy(dh)
    npos_t = torch.from_numpy(npos)
    rc_t = torch.from_numpy(rc).to(torch.int32)
    bound, rk = derive_region_arrays(rc_t, window=window)
    tabs = ext_tables(dh_t, npos_t, d, window_bits=window,
                      LEXT=compute_min_pattern_size(window, literal) + 131)
    col = torch.arange(dh.shape[1], dtype=torch.int32)
    dh_sent = torch.where(col[None] < npos_t[:, None], dh_t.to(torch.int32),
                          0x1FF)
    A, B = plan_fields_ext(dh_sent, *tabs, bound, rc_t, rk, window=window,
                           literal=literal, dlast=int(d[-1]))
    return A, B, npos_t


def _compare(A, B, npos, idx_bits):
    NP = A.shape[1]
    max_out = NP + NP // 8 + 64
    out, st = commit_fields(A, B, npos, max_out=max_out, idx_bits=idx_bits)
    jout, jst = _commit_fields_batch(
        jnp.asarray(A.numpy()), jnp.asarray(B.numpy()),
        jnp.asarray(npos.numpy()), NP=NP, dual=True, max_out=max_out,
        idx_bits=idx_bits, interpret=True)
    jout, jst = np.asarray(jout), np.asarray(jst)
    st = st.numpy()
    for s in range(A.shape[0]):
        for slot in (S_T, S_NBYTES, S_ACC, S_AN, S_ERR):
            assert st[s, slot] == jst[s, slot], (s, slot)
        nb = int(st[s, S_NBYTES])
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
        assert int(out[s, nb:].abs().sum()) == 0
    return st


@pytest.mark.parametrize("window,idx_bits", [(10, 0), (14, 14)])
def test_b3_plain_matches_pallas(window, idx_bits):
    datas = [_rows(1700, window), _rows(900, window + 1), _rows(40, 3),
             np.zeros(0, np.uint8), np.full(12, 65, np.uint8)]
    A, B, npos = _fields(datas, window, 8)
    if idx_bits:
        assert ((B.numpy() >> 15) & 1).any()  # split fields are walked
    st = _compare(A, B, npos, idx_bits)
    assert (st[:, S_ERR] == 0).all()


def test_b3_plain_excess_bits_row():
    # literal 7 and a 0x80+ byte: the walk flags ERR_EXCESS at that field
    # and stops with t = npos; the clean row is unaffected
    good = _rows(1200, 5) & 0x7F
    bad = good.copy()
    bad[700] = 0xC3
    A, B, npos = _fields([good, bad], 10, 7)
    st = _compare(A, B, npos, 0)
    assert st[0, S_ERR] == 0 and st[1, S_ERR] == 1
    assert st[1, S_T] == int(npos[1])

"""The port's host tail walk (engine/tail.py) against the JAX package's tail
owner, the native planned committer (``_native.native_ext_tail_bits``):
the same resume position, bit remainder and model give the same bytes."""

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu_torch.constants import compute_min_pattern_size
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.pipeline_ext import prepare_batch
from tamp_tpu_torch.engine.tail import TAIL_ROWS, ext_tail_bits
from tamp_tpu_torch.ops.encode_commit import S_ACC, S_AN, S_T, commit_fields
from tamp_tpu_torch.ops.match_ext import ext_tables
from tamp_tpu_torch.ops.plan_ext import derive_region_arrays, plan_fields_ext

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 106, rng.integers(1, 6)))
             for _ in range(32)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 32, n))[:n]


def _stage(arrs, d, window, literal):
    """Host prep, tables, planned fields and commit state of a batch."""
    prep, dh, rc, npos = prepare_batch(arrs, window=window)
    dh_t, npos_t = torch.from_numpy(dh), torch.from_numpy(npos)
    rc_t = torch.from_numpy(rc).to(torch.int32)
    tabs = ext_tables(dh_t, npos_t, torch.from_numpy(d.copy()),
                      window_bits=window,
                      LEXT=compute_min_pattern_size(window, literal) + 131)
    bound, rk = derive_region_arrays(rc_t, window=window)
    col = torch.arange(dh.shape[1], dtype=torch.int32)
    dh_sent = torch.where(col[None] < npos_t[:, None], dh_t.to(torch.int32),
                          0x1FF)
    A, B = plan_fields_ext(dh_sent, *tabs, bound, rc_t, rk, window=window,
                           literal=literal, dlast=int(d[-1]))
    NP = dh.shape[1]
    _, state = commit_fields(A, B, npos_t, max_out=NP + NP // 8 + 64,
                             idx_bits=window if window >= 14 else 0)
    return prep, [t.numpy() for t in tabs], B.numpy(), state.numpy()


def _walk_starts(b_row, npos):
    """Model positions of every token start of the planned walk."""
    b = b_row.tolist()
    t, starts = 0, []
    while t < npos:
        starts.append(t)
        t += (b[t] >> 6) & 255
    return starts


def _check(shards, window, literal, dictionary=None):
    d = (np.frombuffer(dictionary, np.uint8) if dictionary is not None
         else dictionary_array(1 << window, literal=literal))
    arrs = [np.frombuffer(bytes(x), np.uint8) for x in shards]
    prep, tabs, B, state = _stage(arrs, d, window, literal)
    for i, arr in enumerate(arrs):
        plans, khat, dhi, _ = prep[i]
        M = dhi.shape[0]

        def both(t_m, acc, an, base, n_rows):
            t_in = (int(np.searchsorted(khat, t_m + 1)) - 1 if t_m < M
                    else arr.shape[0])
            rows = tuple(t[i, base : base + n_rows] for t in tabs)
            got = ext_tail_bits(arr, t_in, dhi, khat, plans, rows, base,
                                window=window, literal=literal, acc=acc,
                                an=an, dict_last=int(d[-1]))
            want = _native.native_ext_tail_bits(
                arr, t_in, dhi, khat, plans, window=window, literal=literal,
                acc=acc, an=an, dictionary=d.tobytes())
            assert got == want, (i, t_m, t_in)

        # at the commit walk's stop, with its bit remainder and only the
        # table rows the pipeline pulls
        st = state[i]
        both(int(st[S_T]), int(st[S_ACC]), int(st[S_AN]),
             max(M - TAIL_ROWS, 0), TAIL_ROWS)
        # every walk entry in the last 60 model positions: resumes inside
        # forced-RLE regions and at ring ends
        for t_m in _walk_starts(B[i], M):
            if t_m >= M - 60:
                both(t_m, 0, 0, 0, M)


@pytest.mark.parametrize("window", [8, 10, 14])
def test_tail_matches_native(window):
    runs = (0, 5, 12, 700, 300) if window <= 10 else (12, 700)
    shards = [_text(900 + 37 * k, window + k) + bytes([98 + k]) * run
              for k, run in enumerate(runs)]
    shards += [b"", b"a", b"abcdefg", b"q" * 15, b"qq" * 8, b"z" * 17]
    _check(shards, window, 8)


def test_tail_ring_end_resumes():
    # window 8: forced chunks and extended matches meet the ring end often
    base = _text(600, 3)
    shards = [base[: 300 + k] + b"m" * (40 + 9 * k) + base[:20]
              for k in range(0, 200, 23)]
    _check(shards, 8, 8)


def test_tail_custom_dictionary_and_literal():
    rng = np.random.default_rng(9)
    dictionary = bytes(rng.integers(97, 106, 1024).astype(np.uint8))
    shards = [_text(700, 4) + b"y" * 90, dictionary[:40]]
    _check(shards, 10, 8, dictionary)
    small = [bytes(b & 63 for b in s) for s in shards]
    _check(small, 10, 6)

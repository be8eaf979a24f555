"""Kernel B5's plain version (tamp_tpu_torch.ops.match_v1) against the JAX
package: the NumPy oracle ``engine/search_np.match_tables`` and the MXU
Pallas kernel in interpret mode, on text and on the seeded hazard rows that
the card tests hold the Hopper kernel to (tests/test_torch_cuda.py makes
them).  Integer tables: equality is exact."""

import numpy as np
import pytest
import torch

from tamp_tpu.dictionary import dictionary_array
from tamp_tpu.engine.search_np import match_tables
from tamp_tpu.ops.match_pallas import match_tables_pallas
from tamp_tpu_torch.ops.encode_fused import v1_cap
from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
from test_torch_cuda import hazard_rows


def _text(n: int, seed: int, lmask: int = 255) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 105, rng.integers(2, 7)))
             for _ in range(48)]
    s = b" ".join(words[int(i)] for i in rng.integers(0, 48, n))[:n]
    arr = np.frombuffer(s, np.uint8) & lmask
    arr[n // 3 : n // 3 + 40] = 7  # a run: 16-byte matches and glue zones
    return arr


def _port(rows, window, literal, probe=True, NP=None):
    """Batch the rows into (S, NP) uint8 and run B5 (plain, on the CPU)."""
    S = len(rows)
    NP = NP or max(r.shape[0] for r in rows)
    data = np.zeros((S, NP), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.shape[0]] = r
    npos = torch.tensor([r.shape[0] for r in rows], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window, literal=8))
    outs = v1_tables(torch.from_numpy(data), npos, d, window_bits=window,
                     cap=v1_cap(window, literal), probe=probe)
    return [[o[i, : r.shape[0]].numpy() for o in outs]
            for i, r in enumerate(rows)]


def _oracle(arr, window, literal):
    t = match_tables(arr, dictionary_array(1 << window, literal=8), window,
                     compute_probe=True)
    flen, fidx = ((t.len16, t.idx16) if v1_cap(window, literal) == 16
                  else (t.len15, t.idx15))
    return [flen.astype(np.int32), fidx, t.probe_len.astype(np.int32),
            t.probe_idx]


@pytest.mark.parametrize("window,literal,n", [
    (8, 8, 700), (10, 8, 1500), (11, 5, 1200), (12, 8, 1000), (15, 8, 500)])
def test_b5_plain_matches_oracle(window, literal, n):
    # (10, 8) has minp 2 and reads cap 15; (11, 5) has minp 3 and cap 16
    arr = _text(n, window, (1 << literal) - 1)
    got = _port([arr], window, literal)[0]
    for g, w in zip(got, _oracle(arr, window, literal)):
        np.testing.assert_array_equal(g, w)
    # without the probe family the main family is the same
    main = _port([arr], window, literal, probe=False)[0]
    assert len(main) == 2
    for g, w in zip(main, got):
        np.testing.assert_array_equal(g, w)


def test_cap15_is_not_min_of_cap16():
    # a 15-byte match at ring slot 0 and a 16-byte one at slot 40: the
    # cap enters the score before the arg-max, so cap 15 picks slot 0 and
    # cap 16 slot 40 (w10 l8 reads cap 15, w11 l5 cap 16)
    rng = np.random.default_rng(3)
    x = rng.integers(128, 256, 16).astype(np.uint8)
    filler = rng.integers(32, 64, 200).astype(np.uint8)
    arr = np.concatenate([x[:15], [1], filler[:24], x, filler[24:84], x,
                          filler[84:]]).astype(np.uint8)
    t = match_tables(arr, dictionary_array(1 << 10, literal=8), 10)
    assert (t.len16[116], t.idx16[116]) == (16, 40)
    assert (t.len15[116], t.idx15[116]) == (15, 0)
    for window, literal in ((10, 8), (11, 5)):
        arr_l = arr & ((1 << literal) - 1)
        got = _port([arr_l], window, literal)[0]
        for g, w in zip(got, _oracle(arr_l, window, literal)):
            np.testing.assert_array_equal(g, w)
    got = _port([arr], 10, 8)[0]
    assert (got[0][116], got[1][116]) == (15, 0)


def test_b5_plain_batch_and_padding():
    window, literal = 10, 8
    rows = [_text(1800, 1), _text(1100, 2), np.full(300, 9, np.uint8),
            _text(17, 3), np.zeros(0, np.uint8)]
    got = _port(rows, window, literal, NP=2048)
    for arr, g in zip(rows, got):
        for a, b in zip(g, _oracle(arr, window, literal)):
            np.testing.assert_array_equal(a, b)
    # positions >= npos hold len 0, index 0
    data = torch.from_numpy(np.stack([_text(1024, 5), _text(1024, 6)]))
    npos = torch.tensor([1000, 37], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window, literal=8))
    for x in v1_tables_plain(data, npos, d, window_bits=window, cap=15,
                             probe=True):
        assert int(x[0, 1000:].abs().sum()) == 0
        assert int(x[1, 37:].abs().sum()) == 0


@pytest.mark.parametrize("window,literal", [(8, 8), (11, 5)])
def test_b5_plain_matches_pallas(window, literal):
    arr = _text(300, window + 7, (1 << literal) - 1)
    cap = v1_cap(window, literal)
    got = _port([arr], window, literal)[0]
    pal = match_tables_pallas(arr, dictionary_array(1 << window, literal=8),
                              window, compute_probe=True, tables=(str(cap),),
                              interpret=True)
    flen, fidx = (pal.len16, pal.idx16) if cap == 16 else (pal.len15,
                                                            pal.idx15)
    for g, w in zip(got, (flen, fidx, pal.probe_len, pal.probe_idx)):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))


def _hazard_port(window, NP, cap):
    data, npos = hazard_rows(window * 3 + cap, 8, NP, window)
    d = torch.from_numpy(dictionary_array(1 << window, literal=8))
    outs = v1_tables_plain(torch.from_numpy(data), torch.from_numpy(npos), d,
                           window_bits=window, cap=cap, probe=True)
    return data, npos, [o.numpy() for o in outs]


@pytest.mark.parametrize("cap", [15, 16])
@pytest.mark.parametrize("window,NP", [(8, 700), (10, 1400)])
def test_b5_plain_matches_oracle_on_hazard_rows(window, NP, cap):
    # all-equal bytes below the oracle's chunk_rows (ROADMAP C), the glue
    # periods, the 15/16 tie, one-byte-only candidates, npos off the block
    # and below 17, a probe at tau = W - 1
    data, npos, outs = _hazard_port(window, NP, cap)
    for r in range(data.shape[0]):
        n = int(npos[r])
        t = match_tables(data[r, :n], dictionary_array(1 << window,
                                                         literal=8),
                         window, compute_probe=True)
        want = ((t.len15, t.idx15) if cap == 15 else (t.len16, t.idx16)) \
            + (t.probe_len, t.probe_idx)
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g[r, :n], w.astype(np.int32))
            assert not g[r, n:].any()
    # the tie: cap 15 takes the lower slot (the 15-byte match), cap 16 the
    # 16-byte one
    assert outs[0][4, 116] == cap and outs[1][4, 116] == (0 if cap == 15
                                                          else 40)
    # one byte and no more at most positions of row 5
    assert (outs[0][5, 300:] == 1).mean() > 0.9


@pytest.mark.parametrize("row", range(8))
def test_b5_plain_matches_pallas_on_hazard_rows(row):
    window, NP = 8, 700
    for cap in (15, 16):
        data, npos, outs = _hazard_port(window, NP, cap)
        n = int(npos[row])
        pal = match_tables_pallas(data[row, :n], dictionary_array(
            1 << window, literal=8), window, compute_probe=True,
            tables=(str(cap),), interpret=True)
        want = ((pal.len15, pal.idx15) if cap == 15
                else (pal.len16, pal.idx16)) + (pal.probe_len, pal.probe_idx)
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g[row, :n],
                                          np.asarray(w).astype(np.int32))

"""Kernels B1's and B2's plain versions (tamp_tpu_torch.ops.match_ext)
against the JAX package: the quarter-lane and byte Pallas kernels in
interpret mode and the NumPy oracles of engine/search_np, on text and on the
seeded hazard rows that the card tests hold the Hopper kernels to
(tests/test_torch_cuda.py makes them).  Integer tables: equality is
exact."""

import numpy as np
import pytest
import torch

from tamp_tpu.dictionary import dictionary_array
from tamp_tpu.engine.search_np import match_tables, match_tables_ext
from tamp_tpu.ops.match_ext_pallas import ext_tables_pallas_host
from tamp_tpu_torch.ops.match_ext import (
    ext_tables, ext_tables_plain, ext_tables_probe, ext_tables_probe_plain,
)
from test_torch_cuda import hazard_rows_ext


def _text(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 105, rng.integers(2, 7)))
             for _ in range(48)]
    s = b" ".join(words[int(i)] for i in rng.integers(0, 48, n))
    return np.frombuffer(s[:n], np.uint8).copy()


def _port(rows, dictionary, window, maxpat, NP=None):
    """Batch the rows into (S, NP) uint8 and run the plain version."""
    S = len(rows)
    NP = NP or max(r.shape[0] for r in rows)
    dh = np.zeros((S, NP), np.uint8)
    for i, r in enumerate(rows):
        dh[i, : r.shape[0]] = r
    npos = torch.tensor([r.shape[0] for r in rows], dtype=torch.int32)
    outs = ext_tables(torch.from_numpy(dh), npos,
                      torch.from_numpy(np.ascontiguousarray(dictionary)),
                      window_bits=window, LEXT=maxpat)
    return [[o[i, : r.shape[0]].numpy() for o in outs]
            for i, r in enumerate(rows)]


@pytest.mark.parametrize("window,n", [(8, 700), (9, 1300), (10, 2500),
                                      (12, 4500)])
def test_b1_plain_matches_pallas_and_oracle(window, n):
    maxpat = 133  # minp + 131: minp is 2 at literal 8 for every window
    d = dictionary_array(1 << window, literal=8)
    arr = _text(n, window)
    arr[n // 3 : n // 3 + 40] = 7  # a run: long matches and glue zones
    l16, i16, lx, ix = _port([arr], d, window, maxpat)[0]
    t16 = match_tables(arr, d, window)
    lxo, ixo = match_tables_ext(arr, d, window, maxpat)
    np.testing.assert_array_equal(l16, t16.len16.astype(np.int32))
    np.testing.assert_array_equal(i16, t16.idx16)
    np.testing.assert_array_equal(lx, lxo)
    np.testing.assert_array_equal(ix, ixo)
    pal = ext_tables_pallas_host(arr, d, window, maxpat, T=512,
                                 interpret=True, swar=True)
    for got, want in zip((l16, i16, lx, ix), pal):
        np.testing.assert_array_equal(got, want)


def test_b1_plain_w15_matches_oracle():
    window, maxpat = 15, 133
    d = dictionary_array(1 << window, literal=8)
    arr = _text(1000, 15)
    arr[100:400] = arr[600:900]  # a long repeat inside the window
    l16, i16, lx, ix = _port([arr], d, window, maxpat)[0]
    t16 = match_tables(arr, d, window)
    lxo, ixo = match_tables_ext(arr, d, window, maxpat)
    np.testing.assert_array_equal(l16, t16.len16.astype(np.int32))
    np.testing.assert_array_equal(i16, t16.idx16)
    np.testing.assert_array_equal(lx, lxo)
    np.testing.assert_array_equal(ix, ixo)


def test_b1_plain_wrap_zone_all_equal():
    # all-equal bytes make every candidate's run maximal and reach the
    # glue diagonals at every ring position (tests/test_search_kernels.py
    # test_ext_pallas_wrap_zone_bound)
    window, maxpat = 8, 133
    d = dictionary_array(1 << window, literal=8)
    arr = np.full(420, 7, np.uint8)
    l16, i16, lx, ix = _port([arr], d, window, maxpat)[0]
    t16 = match_tables(arr, d, window)
    lxo, ixo = match_tables_ext(arr, d, window, maxpat)
    np.testing.assert_array_equal(l16, t16.len16.astype(np.int32))
    np.testing.assert_array_equal(i16, t16.idx16)
    np.testing.assert_array_equal(lx, lxo)
    np.testing.assert_array_equal(ix, ixo)


def test_b1_plain_batch_with_different_npos():
    window, maxpat = 10, 133
    d = dictionary_array(1 << window, literal=8)
    rows = [_text(1800, 1), _text(1100, 2)[:1100], np.full(300, 9, np.uint8)]
    got = _port(rows, d, window, maxpat, NP=2048)
    for arr, (l16, i16, lx, ix) in zip(rows, got):
        t16 = match_tables(arr, d, window)
        lxo, ixo = match_tables_ext(arr, d, window, maxpat)
        np.testing.assert_array_equal(l16, t16.len16.astype(np.int32))
        np.testing.assert_array_equal(i16, t16.idx16)
        np.testing.assert_array_equal(lx, lxo)
        np.testing.assert_array_equal(ix, ixo)


def test_b1_padding_positions():
    # positions >= npos hold len 0 / index 0 (the kernel writes the same)
    window, maxpat = 9, 133
    d = torch.from_numpy(dictionary_array(1 << window, literal=8))
    dh = torch.from_numpy(np.stack([_text(1024, 5), _text(1024, 6)]))
    npos = torch.tensor([1000, 37], dtype=torch.int32)
    a = ext_tables_plain(dh, npos, d, window_bits=window, LEXT=maxpat)
    for x in a:
        assert int(x[0, 1000:].abs().sum()) == 0
        assert int(x[1, 37:].abs().sum()) == 0


@pytest.mark.parametrize("window,n,pallas", [(8, 700, True), (10, 1500, True),
                                             (12, 1200, False),
                                             (15, 500, False)])
def test_b2_plain_probe_matches_pallas_and_oracle(window, n, pallas):
    # kernel B2: B1's four planes plus the probe family (target t + 1, cap
    # 15, ring at t) on the model history
    maxpat = 133
    d = dictionary_array(1 << window, literal=8)
    arr = _text(n, window + 20)
    arr[n // 2 : n // 2 + 40] = 5
    NP = arr.shape[0]
    outs = ext_tables_probe(
        torch.from_numpy(arr[None].copy()),
        torch.tensor([NP], dtype=torch.int32), torch.from_numpy(d),
        window_bits=window, LEXT=maxpat)
    got = [o[0].numpy() for o in outs]
    b1 = _port([arr], d, window, maxpat)[0]
    for g, w in zip(got[:4], b1):
        np.testing.assert_array_equal(g, w)
    t16 = match_tables(arr, d, window, compute_probe=True)
    np.testing.assert_array_equal(got[4], t16.probe_len.astype(np.int32))
    np.testing.assert_array_equal(got[5], t16.probe_idx)
    if pallas:
        pal = ext_tables_pallas_host(arr, d, window, maxpat, probe=True,
                                     interpret=True)
        for g, w in zip(got, pal):
            np.testing.assert_array_equal(g, w)


def _hazard_ext(window):
    # NP = W + 600 stays below both oracles' chunk_rows (ROADMAP C), so
    # they run unchunked
    W = 1 << window
    data, npos = hazard_rows_ext(window * 5, 18, W + 600, window)
    return data, npos, dictionary_array(W, literal=8)


@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("window", [8, 10])
def test_b1_b2_plain_match_oracle_on_hazard_rows(window, probe):
    # the long family's hazard rows (repeats of 17 to LEXT + 20 bytes, the
    # two families at different slots, a tie of long matches, the glue
    # inside long runs, npos off the block and below LEXT) beside B5's
    maxpat = 133
    data, npos, d = _hazard_ext(window)
    fn = ext_tables_probe_plain if probe else ext_tables_plain
    outs = [o.numpy() for o in fn(
        torch.from_numpy(data), torch.from_numpy(npos), torch.from_numpy(d),
        window_bits=window, LEXT=maxpat)]
    for r in range(data.shape[0]):
        n = int(npos[r])
        t16 = match_tables(data[r, :n], d, window, compute_probe=probe)
        lxo, ixo = match_tables_ext(data[r, :n], d, window, maxpat)
        want = [t16.len16, t16.idx16, lxo, ixo]
        if probe:
            want += [t16.probe_len, t16.probe_idx]
        assert len(outs) == len(want)
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g[r, :n], w.astype(np.int32))
            assert not g[r, n:].any()
    dst = data.shape[1] - 150
    # row 12: cap 16 takes the 16-byte match, LEXT the 40-byte one at a
    # higher slot; row 13: two 50-byte matches, one slot
    assert outs[0][12, dst] == 16 and outs[2][12, dst] == 40
    assert outs[1][12, dst] < outs[3][12, dst]
    assert outs[2][13, dst] == 50
    # the LEXT repeat and the periods reach LEXT (at w8 the linear buffer
    # cuts rows 9 and 11 short); row 17 (npos < LEXT) does not
    for r in (10, 14, 15, 16):
        assert outs[2][r].max() == maxpat
    assert 0 < outs[2][17].max() < maxpat


@pytest.mark.parametrize("row", range(18))
def test_b1_b2_plain_match_pallas_on_hazard_rows(row):
    window, maxpat = 8, 133
    data, npos, d = _hazard_ext(window)
    n = int(npos[row])
    got = ext_tables_probe_plain(
        torch.from_numpy(data[row : row + 1, :n].copy()),
        torch.tensor([n], dtype=torch.int32), torch.from_numpy(d),
        window_bits=window, LEXT=maxpat)
    got = [g[0].numpy() for g in got]
    swar = ext_tables_pallas_host(data[row, :n], d, window, maxpat, T=512,
                                  interpret=True, swar=True)
    byte = ext_tables_pallas_host(data[row, :n], d, window, maxpat,
                                  probe=True, interpret=True)
    for g, w in zip(got[:4], swar):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, byte):
        np.testing.assert_array_equal(g, w)

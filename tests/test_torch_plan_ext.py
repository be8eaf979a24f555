"""The port's host prep (engine/plan.py) and field planner (ops/plan_ext.py)
against the JAX package: the native one-pass prep and the JAX planner, on
the same numpy inputs.  Integer planes: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tamp_tpu import _native
from tamp_tpu.dictionary import dictionary_array
from tamp_tpu.ops import plan_ext as jplan
from tamp_tpu_torch.constants import compute_min_pattern_size
from tamp_tpu_torch.engine.plan import ext_prep
from tamp_tpu_torch.ops import plan_ext as tplan
from tamp_tpu_torch.ops.match_ext import ext_tables_plain, ext_tables_probe


def _data(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 8)))
             for _ in range(40)]
    s = bytearray(b" ".join(words[int(i)] for i in rng.integers(0, 40, n)))
    s = s[:n]
    # planned runs (>= 9 bytes), one long enough for several chunks, and
    # short runs for the dynamic RLE path
    s[n // 5 : n // 5 + 600] = b"q" * 600
    s[n // 2 : n // 2 + 12] = b"r" * 12
    s[n // 2 + 40 : n // 2 + 45] = b"s" * 5
    return np.frombuffer(bytes(s), np.uint8)


def test_ext_prep_matches_native():
    for window in (8, 10, 15):
        for n in (0, 5, 9, 3000):
            arr = _data(max(n, 1), window)[:n]
            plans, khat, dh, rc = ext_prep(arr, window)
            jp, jk, jd, jr = _native.native_ext_prep(arr, window)
            np.testing.assert_array_equal(plans, jp)
            np.testing.assert_array_equal(khat, jk)
            np.testing.assert_array_equal(dh, jd)
            np.testing.assert_array_equal(rc, jr)


@pytest.mark.parametrize("window,literal", [
    (8, 8), (9, 7), (10, 8), (11, 6), (12, 8), (13, 5), (14, 8), (15, 8)])
def test_plan_fields_match_jax(window, literal):
    W = 1 << window
    maxpat = compute_min_pattern_size(window, literal) + 131
    d = dictionary_array(W, literal=literal)
    big = window <= 12  # the plain tables cost O(W) per position
    rows = [_data(3000 if big else 1400, window + 1),
            _data(1200 if big else 700, window + 2)]
    if literal < 8:
        rows = [r & ((1 << literal) - 1) for r in rows]
    preps = [ext_prep(r, window) for r in rows]
    NP = 4096 if big else 2048
    S = len(rows)
    dh = np.zeros((S, NP), np.uint8)
    rc = np.zeros((S, NP), np.uint8)
    for i, (_p, _k, m, c) in enumerate(preps):
        dh[i, : m.shape[0]] = m
        rc[i, : c.shape[0]] = c
    npos = np.asarray([p[2].shape[0] for p in preps], np.int32)
    tabs = [t.numpy() for t in ext_tables_plain(
        torch.from_numpy(dh), torch.from_numpy(npos), torch.from_numpy(d),
        window_bits=window, LEXT=maxpat)]
    col = np.arange(NP)[None, :]
    dh_sent = np.where(col < npos[:, None], dh.astype(np.int32), 0x1FF)
    rc32 = rc.astype(np.int32)

    bnd, rk = tplan.derive_region_arrays(torch.from_numpy(rc32),
                                         window=window)
    jb, jk = jplan.derive_region_arrays(jnp.asarray(rc32), window=window)
    np.testing.assert_array_equal(bnd.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jk))

    A, B = tplan.plan_fields_ext(
        torch.from_numpy(dh_sent), *(torch.from_numpy(t) for t in tabs), bnd,
        torch.from_numpy(rc32), rk, window=window, literal=literal,
        dlast=int(d[-1]))
    JA, JB = jplan.plan_fields_ext(
        jnp.asarray(dh_sent), *(jnp.asarray(t) for t in tabs), jb,
        jnp.asarray(rc32), jk, window=window, literal=literal,
        dlast=int(d[-1]))
    np.testing.assert_array_equal(A.numpy(), np.asarray(JA))
    np.testing.assert_array_equal(B.numpy(), np.asarray(JB))
    if window >= jplan.SPLIT_WINDOW:  # the split index field is exercised
        assert (B.numpy() >> 15 & 1).any()


@pytest.mark.parametrize("window,literal", [(8, 8), (10, 8), (11, 6),
                                            (14, 8)])
def test_lazy_plan_fields_match_jax(window, literal):
    # the lazy deferral: a basic match of <= 8 bytes becomes a literal where
    # the probe is longer, clear of the write head, and bound >= 16
    W = 1 << window
    maxpat = compute_min_pattern_size(window, literal) + 131
    d = dictionary_array(W, literal=literal)
    rows = [_data(1500 if window <= 12 else 700, window + 3)
            & ((1 << literal) - 1)]
    preps = [ext_prep(r, window) for r in rows]
    NP = 2048
    dh = np.zeros((1, NP), np.uint8)
    rc = np.zeros((1, NP), np.uint8)
    dh[0, : preps[0][2].shape[0]] = preps[0][2]
    rc[0, : preps[0][3].shape[0]] = preps[0][3]
    npos = np.asarray([preps[0][2].shape[0]], np.int32)
    tabs = [t.numpy() for t in ext_tables_probe(
        torch.from_numpy(dh), torch.from_numpy(npos), torch.from_numpy(d),
        window_bits=window, LEXT=maxpat)]
    col = np.arange(NP)[None, :]
    dh_sent = np.where(col < npos[:, None], dh.astype(np.int32), 0x1FF)
    rc32 = rc.astype(np.int32)
    bnd, rk = tplan.derive_region_arrays(torch.from_numpy(rc32),
                                         window=window)
    kw = dict(window=window, literal=literal, dlast=int(d[-1]))
    A, B = tplan.plan_fields_ext(
        torch.from_numpy(dh_sent), *(torch.from_numpy(t) for t in tabs[:4]),
        bnd, torch.from_numpy(rc32), rk, plen=torch.from_numpy(tabs[4]),
        pidx=torch.from_numpy(tabs[5]), **kw)
    JA, JB = jplan.plan_fields_ext(
        jnp.asarray(dh_sent), *(jnp.asarray(t) for t in tabs[:4]),
        jnp.asarray(bnd.numpy()), jnp.asarray(rc32),
        jnp.asarray(rk.numpy()), plen=jnp.asarray(tabs[4]),
        pidx=jnp.asarray(tabs[5]), lazy=True, **kw)
    np.testing.assert_array_equal(A.numpy(), np.asarray(JA))
    np.testing.assert_array_equal(B.numpy(), np.asarray(JB))
    # the deferral fired: the lazy plan differs from the non-lazy one
    _A0, B0 = tplan.plan_fields_ext(
        torch.from_numpy(dh_sent), *(torch.from_numpy(t) for t in tabs[:4]),
        bnd, torch.from_numpy(rc32), rk, **kw)
    assert not torch.equal(B, B0)

"""Kernel B7's plain version and its input plane (tamp_tpu_torch.ops.
greedy_predict) against the JAX package's Pallas kernel in interpret mode
(``tamp_tpu/ops/greedy_predict_pallas.py``), exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamp_tpu.ops import greedy_predict_pallas as jgp
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.pipeline_ext import greedy_sparse_stage
from tamp_tpu_torch.ops.greedy_predict import (
    entry_pad, greedy_predict_batch, pack_predict_plane,
)
from tamp_tpu_torch.ops.match_v1 import v1_tables

NP = 4096


def _gen(rng, kind: int, n: int, lmask: int) -> bytes:
    if kind == 0:  # run-heavy
        out, tot = [], 0
        while tot < n:
            c = int(rng.integers(1, 500))
            out.append(bytes([int(rng.integers(0, 6)) & lmask]) * c)
            tot += c
        return b"".join(out)[:n]
    words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
             for k in rng.integers(2, 9, 64)]
    return bytes([1 & lmask]).join(
        words[int(i)] for i in rng.integers(0, 64, n // 4))[:n]


def test_pack_predict_plane_equals_jax():
    """Run breaks, a run continuing the dictionary's last byte at position
    0, lengths outside 0..16, indices above 15 bits, garbage beyond npos."""
    rng = np.random.default_rng(11)
    S = 3
    dlast = 0x2E
    dh = rng.integers(0, 4, (S, NP)).astype(np.uint8)
    dh[0, :40] = dlast          # the dlast edge
    dh[1, 100:700] = 9          # a run longer than 255
    dh[2, NP - 20 :] = 5        # a run cut by the end of the row
    npos = np.asarray([NP, 3000, NP - 7], np.int32)
    len16 = rng.integers(-3, 40, (S, NP)).astype(np.int32)
    idx16 = rng.integers(0, 1 << 17, (S, NP)).astype(np.int32)
    got = pack_predict_plane(torch.from_numpy(dh), torch.from_numpy(npos),
                             torch.from_numpy(len16),
                             torch.from_numpy(idx16), dlast=dlast)
    want = jgp.pack_predict_plane(
        jnp.asarray(dh.astype(np.int32)), jnp.asarray(npos),
        jnp.asarray(len16), jnp.asarray(idx16), dlast=dlast, NP=NP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(((got.numpy() >> 20) & 255).max()) == 255


def _planes(window, literal, lazy, shards):
    dh = np.zeros((len(shards), NP), np.uint8)
    for i, s in enumerate(shards):
        dh[i, : len(s)] = np.frombuffer(s, np.uint8)
    npos = torch.tensor([len(s) for s in shards], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window, literal))
    dh = torch.from_numpy(dh)
    tabs = v1_tables(dh, npos, d, window_bits=window, cap=16, probe=lazy)
    pk = pack_predict_plane(dh, npos, tabs[0], tabs[1], dlast=int(d[-1]))
    pp = ((tabs[3] & 0x7FFF) | ((tabs[2] & 15) << 15)) if lazy else None
    return pk, pp, npos


@pytest.mark.parametrize("window,literal,lazy,kinds", [
    (10, 8, False, (2, 2)),
    (10, 8, True, (2, 0)),
    (12, 8, False, (0, 2)),
    (12, 8, True, (2, 2)),
    (10, 6, False, (2, 0)),
    (13, 6, True, (0, 2)),   # minp 3
    (10, 8, False, (2, -1)),  # a shard shorter than 16 bytes
    (11, 8, True, (-1, 0)),
])
def test_plain_walk_equals_pallas_interpret(window, literal, lazy, kinds):
    rng = np.random.default_rng(window * 100 + literal * 10 + lazy)
    lmask = (1 << literal) - 1
    shards = [_gen(rng, k, 3900, lmask) if k >= 0 else b"ab\x01ab\x01ab"
              for k in kinds]
    pk, pp, npos = _planes(window, literal, lazy, shards)
    kw = dict(NP=NP, window=window, literal=literal, lazy=lazy)
    bm, ent, st = greedy_predict_batch(pk, pp, npos, **kw)
    jbm, jent, jst = (np.asarray(x) for x in jgp.greedy_predict_batch(
        jnp.asarray(pk.numpy()), jnp.asarray((pp if lazy else pk).numpy()),
        jnp.asarray(npos.numpy()), interpret=True, **kw))
    np.testing.assert_array_equal(bm.numpy(), jbm)
    # the TPU kernel writes slots 0..2 only (ne, t, flushed chunks)
    np.testing.assert_array_equal(st.numpy()[:, :3], jst[:, :3])
    assert (st.numpy()[:, 3:] == 0).all()
    assert ent.shape == jent.shape == (len(shards), entry_pad(NP, lazy))
    for s in range(len(shards)):
        ne = int(st[s, 0])
        np.testing.assert_array_equal(ent[s, :ne].numpy(), jent[s, :ne])
        bits = np.unpackbits(bm.numpy()[s].view(np.uint8), bitorder="little")
        assert ne == int(bits.sum()) * (2 if lazy else 1)
        if len(shards[s]) < 16:
            assert ne == 0 and int(st[s, 1]) == 0


def test_predictor_pull_volume():
    """On text the walk ships far fewer entries than one per position, but
    enough to cover most token starts (the band of the JAX package's
    tests/test_encode_ext_device.py::test_greedy_predictor_pull_volume)."""
    rng = np.random.default_rng(7)
    data = _gen(rng, 2, 6000, 255)
    n = len(data)
    dh = np.zeros((1, 8192), np.uint8)
    dh[0, :n] = np.frombuffer(data, np.uint8)
    bm, _ent, st = greedy_sparse_stage(
        torch.from_numpy(dh), torch.tensor([n], dtype=torch.int32),
        torch.from_numpy(dictionary_array(1024, 8)), window=10, literal=8,
        lazy=False)
    bits = np.unpackbits(bm.numpy().view(np.uint8), axis=1,
                         bitorder="little")[0, :n]
    ne = int(bits.sum())
    assert ne == int(st[0, 0])
    assert n // 30 < ne < n // 2, ne


def test_wrapper_checks_shapes():
    pk = torch.zeros((1, 100), dtype=torch.int32)
    npos = torch.tensor([100], dtype=torch.int32)
    with pytest.raises(ValueError):
        greedy_predict_batch(pk, None, npos, NP=100, window=10, literal=8,
                             lazy=False)
    pk = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        greedy_predict_batch(pk, None, npos, NP=128, window=10, literal=8,
                             lazy=True)

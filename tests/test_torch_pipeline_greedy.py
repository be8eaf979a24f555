"""The port's greedy-parity encode (engine="device-greedy") against the JAX
package, on the CPU: the cap-16 tables, the encode in both pulls, and the
container.  Every stream must be byte-equal to the JAX package's
``encode_ext_device_greedy`` (Pallas in interpret mode) and to the
reference greedy encoder ``tamp_tpu.compress(..., extended=True)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamp_tpu
from tamp_tpu.engine import pipeline_ext as jpipe
from tamp_tpu.ops.match_ext_pallas import ext_tables_pallas
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine.pipeline_ext import encode_ext_device_greedy
from tamp_tpu_torch.ops.match_v1 import v1_tables
from tamp_tpu_torch.parallel import shard as tshard


def _gen(rng, kind: int, n: int, lmask: int = 255) -> bytes:
    if kind == 0:  # run-heavy
        out, tot = [], 0
        while tot < n:
            c = int(rng.integers(1, 500))
            out.append(bytes([int(rng.integers(0, 6)) & lmask]) * c)
            tot += c
        return b"".join(out)[:n]
    if kind == 1:  # periodic
        p = bytes(int(x) & lmask
                  for x in rng.integers(0, 256, int(rng.integers(2, 30))))
        return (p * (n // len(p) + 1))[:n]
    words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
             for k in rng.integers(2, 9, 64)]
    return bytes([1 & lmask]).join(
        words[int(i)] for i in rng.integers(0, 64, n // 4))[:n]


@pytest.mark.parametrize("window,literal,probe", [
    (10, 8, False), (10, 8, True), (12, 6, True), (8, 8, False)])
def test_b5_cap16_tables_equal_the_f16_family(window, literal, probe):
    """The greedy stage's tables: B5 at cap 16 on the raw shards with the
    extended dictionary equals the JAX stage's ``ext_tables_pallas(...,
    LEXT=16, families="f16")`` below npos (plane order len, idx, plen,
    pidx in both; the probe at cap 15)."""
    rng = np.random.default_rng(window + probe)
    lmask = (1 << literal) - 1
    NP = 4096
    shards = [_gen(rng, 2, 4000, lmask),
              _gen(rng, 0, 1500, lmask) + _gen(rng, 1, 800, lmask)]
    dh = np.zeros((2, NP), np.uint8)
    for i, s in enumerate(shards):
        dh[i, : len(s)] = np.frombuffer(s, np.uint8)
    dh[1, 2300:] = rng.integers(0, 256, NP - 2300)  # garbage beyond npos
    npos = np.asarray([len(s) for s in shards], np.int32)
    d = dictionary_array(1 << window, literal)
    got = v1_tables(torch.from_numpy(dh), torch.from_numpy(npos),
                    torch.from_numpy(d), window_bits=window, cap=16,
                    probe=probe)
    want = ext_tables_pallas(
        jnp.asarray(dh), jnp.asarray(npos), jnp.asarray(d.astype(np.int32)),
        window_bits=window, LEXT=16, T=128, n_chunks=NP // 128, probe=probe,
        interpret=True, families="f16")
    assert len(got) == len(want) == (4 if probe else 2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        for s, n in enumerate(npos):
            np.testing.assert_array_equal(g[s, :n].numpy(), w[s, :n])


@pytest.mark.parametrize("pull", ["sparse", "dense"])
@pytest.mark.parametrize("window,lazy", [
    (10, False), (10, True), (12, False), (12, True)])
def test_encode_equals_jax_and_reference(window, lazy, pull):
    rng = np.random.default_rng(window + 100 * lazy)
    # three shards: one JAX stage call (it splits four or more in two)
    shards = [_gen(rng, 2, 1800),
              _gen(rng, 0, 900) + _gen(rng, 2, 600) + _gen(rng, 1, 600),
              b"ab" * 7]  # shorter than 16 bytes
    got = encode_ext_device_greedy(shards, window=window, lazy_matching=lazy,
                                   pull=pull, device="cpu")
    jax_out = jpipe.encode_ext_device_greedy(
        shards, window=window, lazy_matching=lazy, device_tables=True,
        interpret=True, pull=pull)
    assert got == jax_out
    for s, g in zip(shards, got):
        assert g == tamp_tpu.compress(s, window=window, extended=True,
                                      lazy_matching=lazy)


@pytest.mark.parametrize("lazy", [False, True])
def test_container_equals_jax_and_decodes(lazy):
    rng = np.random.default_rng(31 + lazy)
    data = _gen(rng, 2, 5000) + bytes([4]) * 900 + _gen(rng, 1, 3000)
    kw = dict(shard_size=2000, engine="device-greedy", lazy_matching=lazy)
    blob = tshard.compress_sharded(data, device="cpu", **kw)
    assert blob == jshard.compress_sharded(data, **kw)
    assert bytes(tshard.decompress_sharded_device(blob, device="cpu")) == data
    assert bytes(jshard.decompress_sharded(blob)) == data


def test_custom_dictionary_literal_and_v1_refusal():
    rng = np.random.default_rng(9)
    dictionary = bytes(rng.integers(0, 64, 1 << 11).astype(np.uint8))
    data = dictionary[:1500] + _gen(rng, 2, 3000, 63)
    kw = dict(window=11, literal=6, dictionary=dictionary)
    got = encode_ext_device_greedy([data[:2500], data[2500:]], device="cpu",
                                   **kw)
    assert got == [tamp_tpu.compress(data[:2500], extended=True, **kw),
                   tamp_tpu.compress(data[2500:], extended=True, **kw)]
    blob = tshard.compress_sharded(data, shard_size=2500,
                                   engine="device-greedy", device="cpu", **kw)
    assert bytes(tshard.decompress_sharded_device(
        blob, dictionary=dictionary, device="cpu")) == data
    with pytest.raises(ValueError):
        tshard.compress_sharded(data, engine="device-greedy", extended=False,
                                device="cpu")
    with pytest.raises(ValueError):
        encode_ext_device_greedy([data], pull="bogus", device="cpu")
    assert encode_ext_device_greedy([], device="cpu") == []

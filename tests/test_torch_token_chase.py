"""The port's token tables (ops/decode_wavefront._token_table, the xla
mode's, and ops/token_chase.token_table_chase_plain, kernel B8's plain
version) against the JAX package's ``_token_table`` and its Pallas
``token_table_chase`` in interpret mode, on the same per-bit jump planes.
Exact equality."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamp_tpu
from tamp_tpu.ops import decode_wavefront as jwf
from tamp_tpu.ops.token_chase_pallas import token_table_chase as jchase
from tamp_tpu_torch.ops import decode_wavefront as twf
from tamp_tpu_torch.ops.token_chase import (
    token_table_chase, token_table_chase_plain,
)


def _payloads(window, literal, extended):
    rng = np.random.default_rng(window + literal)
    lmask = (1 << literal) - 1
    out = []
    for n in (0, 1, 700, 2500):
        raw = bytes(rng.integers(0, 256, max(n // 3, 1)).astype(np.uint8))
        raw = bytes(b & lmask for b in raw + b"chase kernel " * (n // 13))
        out.append(tamp_tpu.compress(raw[: max(n, 1)], window=window,
                                     literal=literal, extended=extended)[1:])
    f = io.BytesIO()  # a flushed stream: a byte-align token mid-stream
    c = tamp_tpu.Compressor(f, window=window, literal=literal,
                            extended=extended)
    c.write(bytes(b & lmask for b in b"flush one "))
    c.flush(write_token=True)
    c.write(bytes(b & lmask for b in b"flush two " * 9))
    c.flush(write_token=False)
    out.append(f.getvalue()[1:])
    return out


@pytest.mark.parametrize("window,literal,extended", [
    (10, 8, True), (8, 5, True), (12, 7, False),
])
def test_token_tables_match_jax(window, literal, extended):
    payloads = _payloads(window, literal, extended)
    nxt, _packed = twf.payload_parse(payloads, window=window, literal=literal,
                                     extended=extended, device="cpu")
    NBP = nxt.shape[1]
    T_max = NBP // (1 + literal) + 2

    # the JAX parse at the port's NBP gives the same plane
    L = NBP // 8
    blobs = np.zeros((len(payloads), L + 8), np.uint32)
    for i, p in enumerate(payloads):
        blobs[i, : len(p)] = np.frombuffer(p, np.uint8)
    nb = np.asarray([len(p) for p in payloads], np.int32)
    jnxt, _k, _c, _i, _inv, inc = jax.vmap(
        lambda b, n: jwf._speculative_parse(b, n * 8, NBP, window, literal,
                                            extended))(
        jnp.asarray(blobs), jnp.asarray(nb))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    # with the spare byte, NBP marks exactly the incomplete tokens
    np.testing.assert_array_equal(np.asarray(inc), nxt.numpy() == NBP)

    s_ref, t_ref = jax.vmap(
        lambda n, i: jwf._token_table(n, i, NBP, literal, T_max))(jnxt, inc)
    s_pal, t_pal = jchase(jnxt, NBP, T_max, interpret=True)
    for starts, T in (twf._token_table(nxt, NBP, literal, T_max),
                      token_table_chase_plain(nxt, NBP, T_max),
                      token_table_chase(nxt, NBP, T_max)):
        assert starts.dtype == T.dtype == torch.int32
        np.testing.assert_array_equal(starts.numpy(), np.asarray(s_ref))
        np.testing.assert_array_equal(T.numpy(), np.asarray(t_ref))
        np.testing.assert_array_equal(starts.numpy(), np.asarray(s_pal))
        np.testing.assert_array_equal(T.numpy(), np.asarray(t_pal))
    assert int(t_ref[0]) == 1 and int(t_ref[3]) > 100


def test_chase_drops_incomplete_trailing_token():
    # an orbit 0 -> 9 -> 35 -> ... -> 760, where 760's token is incomplete
    # (tokens of 9 to 35 bits, as the grammar makes them), and a second
    # shard whose first token is incomplete
    NBP, T_max = 1024, 1024 // 9 + 2
    nxt = np.full((2, NBP), NBP, np.int32)
    for b in range(NBP - 50):
        nxt[0, b] = b + 9 + (b % 27)  # off-orbit bits jump too
    orbit = [0]
    while orbit[-1] < 760:
        orbit.append(int(nxt[0, orbit[-1]]))
    nxt[0, orbit[-2]] = 760
    nxt[0, 760] = NBP
    orbit = orbit[:-1]
    want_s = np.zeros((2, T_max), np.int32)
    want_s[0, : len(orbit)] = orbit
    t = torch.from_numpy(nxt)
    for starts, T in (twf._token_table(t, NBP, 8, T_max),
                      token_table_chase_plain(t, NBP, T_max)):
        np.testing.assert_array_equal(starts.numpy(), want_s)
        assert T.tolist() == [len(orbit), 0]
    s_j, t_j = jchase(jnp.asarray(nxt), NBP, T_max, interpret=True)
    np.testing.assert_array_equal(np.asarray(s_j), want_s)
    assert np.asarray(t_j).tolist() == [len(orbit), 0]


def test_chase_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        token_table_chase(torch.zeros((2, 512), dtype=torch.int64), 512, 60)
    with pytest.raises(ValueError):
        token_table_chase(torch.zeros((2, 512), dtype=torch.int32), 1024, 60)

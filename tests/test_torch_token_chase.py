"""The port's token tables (ops/decode_wavefront._token_table, the xla
mode's, and ops/token_chase.token_table_chase_plain, kernel B8's plain
version) against the JAX package's ``_token_table`` and its Pallas
``token_table_chase`` in interpret mode, on the same per-bit jump planes:
the parse's, and the seeded hazard planes that the card tests hold the
Hopper kernel to (tests/test_torch_cuda.py makes them).  Exact
equality."""

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
    TILE, token_table_chase, token_table_chase_plain,
)
from test_torch_cuda import hazard_nxt


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


@pytest.mark.parametrize("long_hop", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_chase_plain_matches_jax_on_hazard_planes(clip, long_hop):
    # hops of 9-34 bits (both JAX tables assume at least 1 + literal), NBP
    # a multiple of 512 but not of the kernel's tile; row 3 (a hop that
    # does not advance) is left out: the JAX chase has no such guard and
    # would not end.  The long-hop plane, which the card's kernel refuses,
    # is one the plain version and JAX agree on.  With ``clip`` T_max is
    # below the token count: JAX drops the same slots but reports the
    # unclipped count.
    NBP = 3 * TILE + 512
    nxt = hazard_nxt(17 + long_hop, 6, NBP, min_hop=9,
                     long_hop=long_hop)[[0, 1, 2, 4, 5]]
    T_max = 200 if clip else NBP // 9 + 2
    starts, T = token_table_chase_plain(torch.from_numpy(nxt), NBP, T_max)
    s_pal, t_pal = jchase(jnp.asarray(nxt), NBP, T_max, interpret=True)
    s_ref, t_ref = jax.vmap(
        lambda n, i: jwf._token_table(n, i, NBP, 8, T_max))(
        jnp.asarray(nxt), jnp.asarray(nxt == NBP))
    for s_j, t_j in ((s_pal, t_pal), (s_ref, t_ref)):
        np.testing.assert_array_equal(starts.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(T.numpy(),
                                      np.minimum(np.asarray(t_j), T_max))
    assert T[3] == 0 and (T[[0, 2, 4]] == T_max).all() == clip


def test_chase_plain_stops_where_the_hazard_planes_end():
    # every hazard row with hops of 1-34 bits: the starts are the orbit
    # from bit 0 up to the bit whose hop reaches NBP (rows 0, 1, 2, 5) or
    # does not advance (row 3), which is no start; row 4 has none
    NBP = 3 * TILE + 512
    nxt = hazard_nxt(23, 6, NBP)
    starts, T = token_table_chase_plain(torch.from_numpy(nxt), NBP, NBP)
    assert T[4] == 0
    stops = {}
    for r in (0, 1, 2, 3, 5):
        row = starts[r, : int(T[r])].numpy()
        assert row[0] == 0 and (nxt[r, row[:-1]] == row[1:]).all()
        stops[r] = stop = nxt[r, row[-1]]
        assert (nxt[r, stop] <= stop) if r == 3 else (nxt[r, stop] == NBP)
        assert not starts[r, int(T[r]):].any()
    assert stops[1] < TILE <= 3 * TILE < stops[0]
    assert NBP // 2 <= stops[2] < NBP // 2 + 34
    assert NBP // 3 <= stops[3] < NBP // 3 + 34

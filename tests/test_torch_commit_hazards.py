"""The plain versions of kernels B4, B3, B6 and B7 against the JAX
package's decode commit, planned-fields commit, lazy stream commit and
greedy predictor kernels (interpret mode), on the seeded hazard streams,
fields, lazy tables and walker planes that the card tests hold the Hopper
kernels to (tests/test_torch_cuda.py makes them all).  This pins the plain
versions on exactly the cases the kernels risk.  Exact equality.  B4's
front (``commit_token_words_plain``, the token words its tile-parallel
launches find) is held to an independent walk, to B8's plain chase and to
the plain commit on the seeded seam planes ``hazard_words`` and on parses
of the hazard streams."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tamp_tpu.ops import greedy_predict_pallas as jgp
from tamp_tpu.ops.decode_commit_pallas import commit_decode_batch
from tamp_tpu.ops.encode_commit_pallas import (
    _commit_fields_batch, encode_commit_batch,
)
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_commit as dc
from tamp_tpu_torch.ops import decode_wavefront as dw
from tamp_tpu_torch.ops.encode_commit import (
    S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NBYTES, S_T, commit_fields,
    commit_v1_lazy,
)
from tamp_tpu_torch.ops.greedy_predict import greedy_predict_batch
from tamp_tpu_torch.ops.token_chase import token_table_chase_plain
from test_torch_cuda import (
    WORD_ROWS, hazard_fields, hazard_lazy_tables, hazard_predict_planes,
    hazard_stream, hazard_words,
)

N_TOKENS = 160  # interpret mode walks a token at a time


@pytest.mark.parametrize("window,kind", [
    (8, "hazards"), (8, "more, double FLUSH"), (10, "out of bounds"),
    (10, "overflow"), (15, "hazards"), (15, "more, double FLUSH")])
def test_b4_plain_matches_pallas_on_hazard_streams(window, kind):
    more = kind.startswith("more")
    streams, lens = zip(*(hazard_stream(
        window * 10 + i, window, more=more, n_tokens=N_TOKENS + 40 * i,
        oob_at=90 + 10 * i if kind == "out of bounds" else -1)
        for i in range(2)))
    max_out = 1 << max(max(lens), 1024).bit_length()
    if kind == "overflow":
        max_out = min(lens) // 2
    skip = 2 if more else 1
    nxt, packed = dw.payload_parse([x[skip:] for x in streams],
                                   window=window, literal=8, extended=True,
                                   device="cpu")
    W = 1 << window
    d = dictionary_array(W, literal=8)
    out, got_lens, errs = dc.commit_decode(
        nxt, packed, torch.from_numpy(d.copy()), torch.from_numpy(d.copy()),
        W=W, more=more, max_out=max_out)
    jo, jl, je = commit_decode_batch(
        jnp.asarray(nxt.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(d.astype(np.int32)), jnp.asarray(d.astype(np.int32)),
        NBP=nxt.shape[1], W=W, more=more, max_out=max_out, unified=False,
        interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(errs.numpy(), np.asarray(je))
    want_err = {"out of bounds": dc.ERR_OOB, "overflow": dc.ERR_OVERFLOW}
    assert errs.tolist() == [want_err.get(kind, dc.ERR_OK)] * 2
    if kind in ("hazards", "more, double FLUSH"):
        assert got_lens.tolist() == list(lens)


@pytest.mark.parametrize("idx_bits,max_out", [
    (0, None), (14, None), (15, None), (0, 64)])
def test_b3_plain_matches_pallas_on_hazard_fields(idx_bits, max_out):
    # rows 0, 1 and 3 of the hazard fields: an error field mid-tile in row
    # 1, values wider than their fields in row 3; the zero-advance row 2 is
    # left out (the TPU kernel spins on it; the card tests hold it)
    NP = 1536
    A, B = (x[[0, 1, 3]] for x in hazard_fields(idx_bits + 5, 4, NP,
                                                 idx_bits))
    npos = np.array([NP, NP - 300, NP - 7], np.int32)
    limit = NP + NP // 8 + 64 if max_out is None else max_out
    out, st = commit_fields(torch.from_numpy(A), torch.from_numpy(B),
                            torch.from_numpy(npos), max_out=limit,
                            idx_bits=idx_bits)
    jout, jst = _commit_fields_batch(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(npos), NP=NP, dual=True,
        max_out=limit, idx_bits=idx_bits, interpret=True)
    jout, jst = np.asarray(jout), np.asarray(jst)
    st = st.numpy()
    for s in range(3):
        for slot in (S_T, S_NBYTES, S_ACC, S_AN, S_ERR):
            assert st[s, slot] == jst[s, slot], (s, slot)
        nb = min(int(st[s, S_NBYTES]), limit & ~3)
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
        assert int(out[s, nb:].abs().sum()) == 0
    assert st[:, S_ERR].tolist() == [0, 1, 0]
    if max_out is not None:
        assert (st[:, S_NBYTES] > max_out).any()


@pytest.mark.parametrize("window,literal,max_out", [
    (10, 8, None), (10, 7, None), (11, 5, None), (10, 7, 401)])
def test_b6_plain_matches_pallas_on_hazard_tables(window, literal, max_out):
    # three of the TPU kernel's 512-position tiles, seams every 512
    NP = 1536
    P, Q, npos = hazard_lazy_tables(window * 10 + literal, 6, NP, window,
                                    literal, tile=512)
    limit = NP + NP // 8 + 64 if max_out is None else max_out
    kw = dict(window=window, literal=literal, max_out=limit)
    out, st = commit_v1_lazy(torch.from_numpy(P), torch.from_numpy(Q),
                             torch.from_numpy(npos), **kw)
    jout, jst = encode_commit_batch(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(npos), NP=NP, lazy=True,
        interpret=True, **kw)
    jout, jst, st = np.asarray(jout), np.asarray(jst), st.numpy()
    for s in range(6):
        for slot in (S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR):
            assert st[s, slot] == jst[s, slot], (s, slot)
        nb = min(int(st[s, S_NBYTES]), limit)
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
        assert int(out[s, nb:].abs().sum()) == 0
    assert st[3, S_CSZ] > 255          # a deferred size above 255
    assert st[4, S_CIDX] >= 0          # the stop leaves a cache
    assert st[5, S_T] == 0             # npos < 16: no walk
    if literal < 8:                    # excess literals, deferred and not
        assert st[1:3, S_ERR].tolist() == [1, 1] and st[1, S_CIDX] >= 0
    if max_out is not None:
        assert (st[:, S_NBYTES] > max_out).any()


@pytest.mark.parametrize("window,literal,lazy", [
    (10, 8, False), (10, 8, True), (14, 6, True)])
def test_b7_plain_matches_pallas_on_hazard_planes(window, literal, lazy):
    # the TPU kernel needs NP % 4096 == 0: seams every 1024 here
    NP = 4096
    pk, pp, npos = hazard_predict_planes(window + lazy, 5, NP, window,
                                         literal, tile=1024)
    kw = dict(NP=NP, window=window, literal=literal, lazy=lazy)
    bm, ent, st = greedy_predict_batch(torch.from_numpy(pk),
                                       torch.from_numpy(pp),
                                       torch.from_numpy(npos), **kw)
    jbm, jent, jst = (np.asarray(x) for x in jgp.greedy_predict_batch(
        jnp.asarray(pk), jnp.asarray(pp if lazy else pk), jnp.asarray(npos),
        interpret=True, **kw))
    np.testing.assert_array_equal(bm.numpy(), jbm)
    # the TPU kernel writes slots 0..2 only (ne, t, flushed chunks)
    np.testing.assert_array_equal(st.numpy()[:, :3], jst[:, :3])
    ne = st[:, 0].tolist()
    for s, n in enumerate(ne):
        np.testing.assert_array_equal(ent[s, :n].numpy(), jent[s, :n])
    assert ne[1] == 0 and ne[4] == 0 and int(st[4, 1]) == 0
    assert min(ne[0], ne[2], ne[3]) > 0


def _chain(row):
    """An independent walk of one plane row: (the visited words, stop word
    included, their bit positions, the complete tokens)."""
    words, at, c = [], [], 0
    while c < len(row):
        words.append(row[c])
        at.append(c)
        d = (row[c] >> 11) & 63
        if d == 0:
            return words, at, len(words) - 1
        c += d
    return words, at, len(words)


def _front_checks(pk, *, W, more, max_out, min_bits=1):
    """B4's plain front on ``pk`` against the independent walk, B8's plain
    chase on the pair form and the plain commit on the plane, also with
    the front's records sized by ``min_bits`` (which ``pk``'s hops meet);
    returns the front's T."""
    S, NBP = pk.shape
    words, T = dc.commit_token_words_plain(pk)
    # the pair form (fuse_parse's inverse): delta 0 marks nxt = NBP
    delta = (pk.to(torch.int64) >> 11) & 63
    b = torch.arange(NBP)[None, :]
    nxt = torch.where(delta == 0, NBP, b + delta).to(torch.int32)
    starts, T8 = token_table_chase_plain(nxt, NBP, NBP)
    for r in range(S):
        want, at, t = _chain(pk[r].tolist())
        assert int(T[r]) == t
        assert words[r, : len(want)].tolist() == want
        assert not words[r, len(want):].any()
        # a last token that crosses NBP is complete in the walk, while the
        # chase drops it as incomplete (no parse makes one: its delta is 0)
        crosses = t > 0 and t == len(want) and \
            at[-1] + ((want[-1] >> 11) & 63) >= NBP
        assert int(T8[r]) == t - crosses
        assert starts[r, : t - crosses].tolist() == at[: t - crosses]
    d = torch.from_numpy(dictionary_array(W, literal=8))
    kw = dict(W=W, more=more, max_out=max_out)
    out, lens, errs = dc.commit_decode_plain(pk, d, d, **kw)
    di = bytes(d.numpy().tobytes())
    for r in range(S):  # the commit reads the compact words in order
        o = np.zeros(max_out, np.uint8)
        n = int(T[r]) + 1
        assert dc._walk(words[r, :n].tolist(), W, more, max_out, di, di,
                        o) == (int(lens[r]), int(errs[r]))
        assert np.array_equal(o, out[r].numpy())
    assert (T < dc.front_slots(NBP, min_bits)).all()
    got = dc._commit_words(pk, d, d, min_bits=min_bits, **kw)
    for a, b in zip(got, (out, lens, errs, T)):
        assert torch.equal(a, b)
    return T


@pytest.mark.parametrize("window,NBP,S,more,overflow", [
    (8, 512, 8, False, False),              # NBP of one tile
    (10, 3 * 4096 + 512, 16, True, False),  # not a multiple of the tile
    (10, 3 * 4096 + 512, 8, False, True),   # overflow in a late tile
    (15, 2 * 4096 + 1024, 8, True, False),
    (10, 2 * 4096 + 1024, 203, False, False),  # S = 203, mixed lengths
    (10, 4096, 8, False, False)])           # 8 tiles of 512
def test_b4_front_plain_on_seam_planes(window, NBP, S, more, overflow):
    # seams where the kernel's front cuts its tiles
    pk = torch.from_numpy(hazard_words(window * 1000 + S, S, NBP, window,
                                       more=more, tile=dc.front_tile(NBP)))
    W = 1 << window
    d = torch.from_numpy(dictionary_array(W, literal=8))
    _o, lens, errs = dc.commit_decode_plain(pk, d, d, W=W, more=more,
                                            max_out=1 << 20)
    max_out = 1 << 20
    if overflow:  # past 90 % of the shortest decode of a chain to NBP
        max_out = int(lens[0]) * 9 // 10
    T = _front_checks(pk, W=W, more=more, max_out=max_out)
    rows = {WORD_ROWS[r % 8]: r for r in range(min(S, 8))}
    assert int(T[rows["no token"]]) == 0
    assert int(errs[rows["out of bounds in the last tile"]]) == dc.ERR_OOB
    assert int(T[rows["hops of 1-3 bits"]]) > NBP // 3
    # the first tile's stop ends the chain there
    assert int(T[rows["stop in the first tile"]]) <= dc.front_tile(NBP)
    if overflow:
        _o, _l, errs = dc.commit_decode_plain(pk, d, d, W=W, more=more,
                                              max_out=max_out)
        assert int(errs[0]) == dc.ERR_OVERFLOW


@pytest.mark.parametrize("window,NBP,S,more,min_hop", [
    (8, 512, 8, False, 9),                  # NBP of one tile
    (10, 3 * 4096 + 512, 16, True, 6),      # not a multiple of the tile
    (15, 2 * 4096 + 1024, 8, True, 9),
    (10, 2 * 4096 + 1024, 203, False, 7),   # S = 203, mixed lengths
    (10, 64 * 4096 + 512, 4, False, 9)])    # tiles of 4096
def test_b4_front_plain_on_seam_planes_with_a_floor(window, NBP, S, more,
                                                    min_hop):
    # hops of min_hop bits or more (a parse's 1 + literal), the front's
    # records sized by that floor
    pk = torch.from_numpy(hazard_words(window * 100 + S, S, NBP, window,
                                       more=more, tile=dc.front_tile(NBP),
                                       min_hop=min_hop))
    T = _front_checks(pk, W=1 << window, more=more, max_out=1 << 20,
                      min_bits=min_hop)
    if S > 7:  # the densest row
        assert int(T[7]) > NBP // (min_hop + 3)


@pytest.mark.parametrize("min_bits", [3, 9, 64])
def test_b4_plain_refuses_a_chain_past_its_slots(min_bits):
    # a plane whose hops fall below the floor: a shard whose chain holds
    # front_slots(NBP, min_bits) complete tokens or more gets ERR_INVALID
    # and no bytes; the others decode as with room for every bit
    NBP, S, W = 3 * 4096 + 512, 16, 1024
    pk = torch.from_numpy(hazard_words(17, S, NBP, 10, tile=512))
    d = torch.from_numpy(dictionary_array(W, literal=8))
    kw = dict(W=W, more=False, max_out=1 << 20)
    out, lens, errs, T = dc._commit_words(pk, d, d, min_bits=min_bits, **kw)
    full = dc.commit_decode_plain(pk, d, d, **kw)
    refused = T >= dc.front_slots(NBP, min_bits)
    assert refused.any() and not refused.all()
    assert (errs[refused] == dc.ERR_INVALID).all()
    assert (lens[refused] == 0).all() and not out[refused].any()
    for a, b in zip((out, lens, errs), full):
        assert torch.equal(a[~refused], b[~refused])
    assert torch.equal(T, dc.commit_token_words_plain(pk)[1])


@pytest.mark.parametrize("window,kind", [
    (8, "hazards"), (10, "more, double FLUSH"), (10, "out of bounds"),
    (15, "hazards"), (15, "trailing incomplete token")])
def test_b4_front_plain_on_hazard_stream_parses(window, kind):
    more = kind.startswith("more")
    streams = [hazard_stream(window * 10 + i, window, more=more,
                             n_tokens=300 + 100 * i,
                             oob_at=200 if kind == "out of bounds" else -1)[0]
               for i in range(3)]
    if kind.startswith("trailing"):
        streams = [x[:-2] for x in streams]
    skip = 2 if more else 1
    pk = dw.payload_parse([x[skip:] for x in streams], window=window,
                          literal=8, extended=True, device="cpu", fused=True)
    T = _front_checks(pk, W=1 << window, more=more, max_out=1 << 16,
                      min_bits=9)  # 1 + literal
    assert (T > 0).all()

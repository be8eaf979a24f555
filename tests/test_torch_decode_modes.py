"""The port's wavefront decode modes ``xla`` and ``chase``
(ops/decode_wavefront.decode_group: parse, token table, wavefront_finish
with kernel X1's plain version) against the JAX package's
``_wavefront_batch`` in the same modes, at the same NBP and max_out: bytes,
lengths and error codes, exactly.  Every case shares one NBP, one max_out
and three shards (its one or two streams, an empty payload where it has
one, and a filler payload of L - 1 zero bytes, which sets the parse's
bucket), so the JAX side compiles one program per configuration and
mode."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu._native.stream import NativeCompressor
from tamp_tpu.ops import decode_wavefront as jwf
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_wavefront as twf

from test_torch_cuda import x1_hazard_rows

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")

L = 4096          # payload bytes of every case's parse (the filler's bucket)
NBP = 8 * L
MAX_OUT = 8192
RLE_DATA = (b"\x00" * 4000 + b"ab" * 600 + b"\xff" * 999 + b"tail"
            + b"\x00" * 9)  # tests/test_decode_wavefront.py's truncation data


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 7)))
             for _ in range(30)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 30, n))[:n]


def _reset_stream(dictionary=None):
    f = io.BytesIO()
    c = NativeCompressor(f, window=10, literal=8, extended=True,
                         dictionary=None if dictionary is None
                         else bytearray(dictionary), dictionary_reset=True)
    c.write(b"first segment first segment " * 8)
    c.flush(write_token=True)
    c.write(b"after a flush " * 5)
    c.reset_dictionary()
    c.write(b"second segment second segment " * 8 + b"z" * 60)
    c.flush(write_token=False)
    return f.getvalue()


def _case(name):
    """(streams (1 or 2), dict_init, raw outputs or None)."""
    t = _text(3000, 1)
    d10 = dictionary_array(1024, literal=8)
    if name == "extended":
        raws = [t[:2000] + b"a" * 300, t[500:]]
        return [tamp_tpu.compress(r, window=10, literal=8) for r in raws], \
            d10, raws
    if name == "more":
        return [_reset_stream()], d10, None
    if name == "more custom":
        rng = np.random.default_rng(4)
        custom = rng.integers(97, 110, 1024).astype(np.uint8)
        return [_reset_stream(custom.tobytes())], custom, None
    if name == "w8 l5":
        raw = bytes(b & 31 for b in t[:700])
        return [tamp_tpu.compress(raw, window=8, literal=5)], \
            dictionary_array(256, literal=5), [raw]
    if name == "v1 w12":
        return [tamp_tpu.compress(t, window=12, literal=8, extended=False)], \
            dictionary_array(4096, literal=8), [t]
    if name == "custom":
        rng = np.random.default_rng(3)
        custom = rng.integers(97, 110, 1024).astype(np.uint8)
        return [tamp_tpu.compress(t[:900], window=10, literal=8,
                                  dictionary=custom.tobytes())], custom, \
            [t[:900]]
    if name == "corrupt":
        bad = bytearray(tamp_tpu.compress(b"zqx" * 400, window=10, literal=8))
        bad[len(bad) // 2] ^= 0x5A
        return [bytes(bad)], d10, None
    if name == "overflow":
        raw = b"\x00" * 9000 + t[:100]
        return [tamp_tpu.compress(raw, window=10, literal=8)], d10, None
    if name.startswith("rle w"):
        w = int(name[5:])
        return [tamp_tpu.compress(RLE_DATA, window=w)], \
            dictionary_array(1 << w, literal=8), [RLE_DATA]
    if name == "w15":
        raw = t + t[:1500]
        return [tamp_tpu.compress(raw, window=15, literal=8)], \
            dictionary_array(1 << 15, literal=8), [raw]
    raise KeyError(name)


CASES = ["extended", "more", "more custom", "w8 l5", "v1 w12", "custom",
         "corrupt", "overflow", "rle w8", "rle w9", "rle w10", "w15"]


@pytest.mark.parametrize("mode", ["xla", "chase"])
@pytest.mark.parametrize("name", CASES)
def test_decode_group_matches_jax(name, mode):
    streams, d_init, raws = _case(name)
    h = streams[0][0]
    window = (h >> 5) + 8
    literal = ((h >> 3) & 3) + 5
    extended = bool((h >> 1) & 1)
    more = bool(h & 1)
    skip = 2 if more else 1
    payloads = [s[skip:] for s in streams]
    payloads += [b""] * (2 - len(payloads)) + [bytes(L - 1)]
    d_reset = dictionary_array(1 << window, literal if extended else 8)

    out, lens, errs = twf.decode_group(
        payloads, window=window, literal=literal, extended=extended,
        more=more, dict_init=d_init, dict_reset=d_reset, max_out=MAX_OUT,
        device="cpu", mode=mode)

    blobs = np.zeros((3, L + 8), np.uint8)
    for i, p in enumerate(payloads):
        blobs[i, : len(p)] = np.frombuffer(p, np.uint8)
    nb = np.asarray([len(p) for p in payloads], np.int32)
    jo, jl, je = jwf._wavefront_batch(
        jnp.asarray(blobs), jnp.asarray(nb),
        jnp.asarray(d_init.astype(np.int32)),
        jnp.asarray(d_reset.astype(np.int32)), NBP=NBP, window=window,
        literal=literal, extended=extended, more=more, max_out=MAX_OUT,
        mode=mode)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(errs.numpy(), np.asarray(je))

    errs = errs.tolist()
    assert errs[2] == 0 and int(lens[2]) > 0  # the filler decodes
    if raws is not None:
        assert errs[:2] == [0, 0]
        for i, raw in enumerate(raws):
            assert out[i, : int(lens[i])].numpy().tobytes() == raw
    if name.startswith("more"):
        custom = d_init.tobytes() if name == "more custom" else None
        want = bytes(_native.native_decompress(streams[0],
                                               dictionary=custom))
        assert errs[0] == 0
        assert out[0, : int(lens[0])].numpy().tobytes() == want
    if name == "overflow":
        assert errs[0] == twf.ERR_OVERFLOW
    if name == "corrupt":
        assert errs[0] != 0


def _jax_fold(seg, S_seg, w_unc, trunc, W):
    """The JAX package's window-write deficit loop, as written in
    tamp_tpu/ops/decode_wavefront.py (_wavefront_finish, ``tr_body``), over
    one shard's token arrays."""
    T_max = seg.shape[0]
    tr_id = jnp.cumsum(trunc.astype(jnp.int32)) - 1
    n_tr = jnp.sum(trunc.astype(jnp.int32))
    tr_tok = jnp.zeros(T_max, jnp.int32).at[
        jnp.where(trunc, tr_id, T_max)
    ].set(jnp.arange(T_max, dtype=jnp.int32), mode="drop")

    def tr_cond(st):
        return st[0] < n_tr

    def tr_body(st):
        i, D, cur_seg, defs = st
        t = tr_tok[i]
        sg = seg[t]
        D = jnp.where(sg != cur_seg, 0, D)
        a_mod = jnp.remainder(S_seg[t] - D, W)
        room = W - a_mod
        d = jnp.maximum(0, w_unc[t] - room)
        return i + 1, D + d, sg, defs.at[t].set(d)

    z = w_unc[0] * 0
    return lax.while_loop(tr_cond, tr_body, (z, z, z, w_unc * 0))[3]


@pytest.mark.parametrize("W", [256, 1024])
def test_trunc_deficits_plain_matches_jax_fold(W):
    """X1's plain version against the JAX fold on random token arrays with
    segments, truncating tokens near the ring end and long runs."""
    rng = np.random.default_rng(W)
    S, T_max = 3, 400
    seg = np.cumsum(rng.random((S, T_max)) < 0.02, axis=1).astype(np.int32)
    w_unc = rng.integers(0, 40, (S, T_max)).astype(np.int32)
    trunc = rng.random((S, T_max)) < 0.4
    trunc[2] = False  # a shard with no truncating token
    S_seg = np.zeros((S, T_max), np.int32)
    for s in range(S):  # segment-relative exclusive sums of w_unc
        acc = 0
        for t in range(T_max):
            if t and seg[s, t] != seg[s, t - 1]:
                acc = 0
            S_seg[s, t] = acc
            acc += int(w_unc[s, t])
    fold = jax.jit(_jax_fold, static_argnums=4)
    for s in range(S):
        want = np.asarray(fold(jnp.asarray(seg[s]), jnp.asarray(S_seg[s]),
                               jnp.asarray(w_unc[s]), jnp.asarray(trunc[s]),
                               W))
        tok = np.nonzero(trunc[s])[0]
        pad = T_max - tok.size
        comp = [torch.from_numpy(np.pad(x[s, tok], (0, pad))[None])
                for x in (seg, S_seg, w_unc)]
        defs_c = twf.trunc_deficits(
            *comp, torch.tensor([tok.size], dtype=torch.int32), W)
        got = np.zeros(T_max, np.int32)
        got[tok] = defs_c[0, : tok.size].numpy()
        np.testing.assert_array_equal(got, want)
        if s < 2:
            assert want.any()  # some write was truncated


def _x1_chunked(seg, s_c, w_c, n_tr, W):
    """Kernel X1's resolution (csrc/decode_wavefront.cu, ``fold_chunk``)
    in numpy: per shard, chunks of 32 tokens; a pass gives every
    unresolved token D as it stood before the first of them, or 0 where a
    segment change lies between, takes the first token whose deficit is
    nonzero, and resolves every token up to it."""
    chunk = 32
    defs = np.zeros(seg.shape, np.int32)
    for s in range(seg.shape[0]):
        D = cur = 0
        for c in range(0, int(n_tr[s]), chunk):
            m = min(chunk, int(n_tr[s]) - c)
            sg, sv, wv = (x[s, c : c + m].astype(np.int64)
                          for x in (seg, s_c, w_c))
            chg = sg != np.concatenate([[cur], sg[:-1]])
            pos = 0
            while pos < m:
                Dl = np.where(np.cumsum(chg[pos:]) > 0, 0, D)
                d = np.maximum(0, wv[pos:] - (W - ((sv[pos:] - Dl)
                                                   & (W - 1))))
                hit = np.flatnonzero(d)
                f = int(hit[0]) if hit.size else m - 1 - pos
                defs[s, c + pos : c + pos + f + 1] = d[: f + 1]
                D, cur = int(Dl[f] + d[f]), int(sg[pos + f])
                pos += f + 1
    return defs


@pytest.mark.parametrize("W", [256, 1024])
def test_trunc_deficits_chunked_matches_plain_and_jax_fold(W):
    """X1's chunked speculative resolution against its plain version and
    the JAX fold on the hazard rows of tests/test_torch_cuda.py: deficits
    at every token, segment changes inside a chunk and at its first token,
    n_tr = 0, 31, 32, 33, 127, 128, 129 and T_max."""
    T_max = 200
    arrays = x1_hazard_rows(W, 24, T_max, W)
    seg, s_c, w_c, n_tr = arrays
    got = _x1_chunked(*arrays, W)
    plain = twf.trunc_deficits(*(torch.from_numpy(x) for x in arrays), W)
    np.testing.assert_array_equal(got, plain.numpy())
    fold = jax.jit(_jax_fold, static_argnums=4)
    for s in range(seg.shape[0]):
        want = np.asarray(fold(jnp.asarray(seg[s]), jnp.asarray(s_c[s]),
                               jnp.asarray(w_c[s]),
                               jnp.arange(T_max) < n_tr[s], W))
        np.testing.assert_array_equal(got[s], want)
    assert (got[0] > 0).all() and (got[6, 31::32] > 0).all()
    lengths = {0, 31, 32, 33, 127, 128, 129, T_max}
    assert set(n_tr.tolist()) & lengths == lengths


def test_modes_select_and_reject(monkeypatch):
    stream = tamp_tpu.compress(RLE_DATA, window=9)
    monkeypatch.delenv("TAMP_TPU_DECODE", raising=False)
    assert twf.resolve_mode(None) == "commit"
    for mode in twf.MODES:
        monkeypatch.setenv("TAMP_TPU_DECODE", mode)
        assert twf.resolve_mode(None) == mode
        assert twf.decode_shards_wavefront([stream], max_out=8192,
                                           device="cpu") == [RLE_DATA]
    monkeypatch.setenv("TAMP_TPU_DECODE", "bogus")
    assert twf.resolve_mode(None) == "commit"
    with pytest.raises(ValueError):
        twf.decode_shards_wavefront([stream], max_out=8192, device="cpu",
                                    mode="bogus")

"""The port's decode (ops/decode_wavefront.py parse + kernel B4's plain
version) against the JAX package's per-bit parse and its decode commit
kernel in interpret mode, on the same payloads.  Exact equality."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu._native.stream import NativeCompressor
from tamp_tpu.ops import decode_wavefront as jwf
from tamp_tpu.ops.decode_commit_pallas import commit_decode_batch
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_wavefront as twf
from tamp_tpu_torch.ops.decode_commit import ERR_OK, commit_decode

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


def _reset_stream():
    f = io.BytesIO()
    c = NativeCompressor(f, window=10, literal=8, extended=True,
                         dictionary_reset=True)
    c.write(b"first segment first segment " * 8)
    c.reset_dictionary()
    c.write(b"second segment second segment " * 8 + b"z" * 60)
    c.flush(write_token=False)
    return f.getvalue()


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 7)))
             for _ in range(30)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 30, n))[:n]


def _cases():
    """(streams, dict_init, dict_reset, max_out) groups of one header."""
    t = _text(3000, 1)
    ext = [tamp_tpu.compress(t[:2000] + b"a" * 300, window=10, literal=8),
           tamp_tpu.compress(t[500:], window=10, literal=8)]
    d10 = dictionary_array(1024, literal=8)
    small = [tamp_tpu.compress(bytes(b & 31 for b in t[:700]), window=8,
                               literal=5)]
    d8 = dictionary_array(256, literal=5)
    v1 = [tamp_tpu.compress(t, window=12, literal=8, extended=False)]
    d12 = dictionary_array(4096, literal=8)
    rng = np.random.default_rng(3)
    custom = rng.integers(97, 110, 1024).astype(np.uint8)
    cus = [tamp_tpu.compress(t[:900], window=10, literal=8,
                             dictionary=custom.tobytes())]
    bad = bytearray(tamp_tpu.compress(b"zqx" * 400, window=10, literal=8))
    bad[len(bad) // 2] ^= 0x5A
    return [
        (ext, d10, d10, 4096),
        ([_reset_stream()], d10, d10, 4096),
        (small, d8, d8, 1024),
        (v1, d12, d12, 4096),
        (cus, custom, d10, 1024),
        ([bytes(bad)], d10, d10, 4096),
        (ext, d10, d10, 1024),  # output overflow verdict
    ]


def _payloads(streams):
    h = streams[0][0]
    skip = 2 if h & 1 else 1
    return h, [s[skip:] for s in streams]


@pytest.mark.parametrize("case", range(7))
def test_parse_and_commit_match_jax(case):
    streams, d_init, d_reset, max_out = _cases()[case]
    h, payloads = _payloads(streams)
    window = (h >> 5) + 8
    literal = ((h >> 3) & 3) + 5
    extended = bool((h >> 1) & 1)
    more = bool(h & 1)
    L = jwf._pow2_bucket(max(len(p) for p in payloads), 64)
    NBP = 8 * L
    blobs = np.zeros((len(payloads), L + 8), np.uint8)
    for i, p in enumerate(payloads):
        blobs[i, : len(p)] = np.frombuffer(p, np.uint8)
    nb = np.asarray([len(p) for p in payloads], np.int32)

    parse = twf.speculative_parse(torch.from_numpy(blobs).to(torch.int64),
                                  torch.from_numpy(nb) * 8, NBP, window,
                                  literal, extended)
    for i in range(len(payloads)):
        jp = jwf._speculative_parse(
            jnp.asarray(blobs[i].astype(np.uint32)), int(nb[i]) * 8, NBP,
            window, literal, extended)
        for got, want in zip(parse, jp[:4]):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))

    nxt, kind, cnt, idx = parse
    packed = kind | (cnt << 3) | (idx << 11)
    W = 1 << window
    out, lens, errs = commit_decode(
        nxt, packed, torch.from_numpy(d_init.copy()),
        torch.from_numpy(d_reset.copy()), W=W, more=more, max_out=max_out)
    jo, jl, je = commit_decode_batch(
        jnp.asarray(nxt.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(d_init.astype(np.int32)),
        jnp.asarray(d_reset.astype(np.int32)), NBP=NBP, W=W, more=more,
        max_out=max_out, unified=not extended, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(errs.numpy(), np.asarray(je))
    if case in (0, 1, 2, 3, 4):
        for i, s in enumerate(streams):
            ref = _native.native_decompress(
                s, dictionary=None if case != 4 else d_init.tobytes())
            assert int(errs[i]) == ERR_OK
            assert out[i, : int(lens[i])].numpy().tobytes() == bytes(ref)
    if case == 6:
        assert (errs.numpy() != ERR_OK).any()


def test_decode_shards_custom_dictionary_reset_reverts_to_default():
    # after a double FLUSH the window is the DEFAULT dictionary even when the
    # stream started from a custom one (tests/test_decode_wavefront.py)
    rng = np.random.default_rng(4)
    custom = bytes(rng.integers(97, 110, 1024).astype(np.uint8))
    f = io.BytesIO()
    c = NativeCompressor(f, window=10, literal=8, extended=True,
                         dictionary=bytearray(custom), dictionary_reset=True)
    c.write(custom[:300] + b" first")
    c.reset_dictionary()
    c.write(b"second part, default window " * 4)
    c.flush(write_token=False)
    stream = f.getvalue()
    want = bytes(_native.native_decompress(stream, dictionary=custom))
    got = twf.decode_shards_wavefront([stream], dictionary=custom,
                                      max_out=4096, device="cpu")
    assert got == [want]


def test_decode_shards_groups_by_payload_budget(monkeypatch):
    # a small budget splits the shards into several device groups; the
    # result is the same list
    streams = [tamp_tpu.compress(_text(1500 + 300 * k, k), window=10,
                                 literal=8) for k in range(4)]
    streams.append(tamp_tpu.compress(b"", window=10, literal=8))
    want = [bytes(_native.native_decompress(s)) for s in streams]
    for budget in (1 << 23, 900):
        monkeypatch.setattr(twf, "GROUP_PAYLOAD_BYTES", budget)
        got = twf.decode_shards_wavefront(streams, max_out=4096,
                                          device="cpu")
        assert got == want


# Two inputs whose w10/l8 payload is exactly 64 bytes, a power-of-two
# bucket, with the last token ending on the payload's last bit: parsed at
# NBP = 8 x 64 that token's end equals the incomplete-token mark NBP, and
# the commit walk dropped it (62 and 65 bytes came back).
EXACT_BUCKET = [
    b"koloekj oooihgodhhofknlhm knmifjnbbogcefhgmoepi hddl fgniboiemaa",
    b"nho ofooefkplpialoebgddecidoijnldhdhhbbmjekfkpcoad aafjjndimnljbcp",
]


@pytest.mark.parametrize("mode", ["commit", "chase", "xla", "serial"])
@pytest.mark.parametrize("raw", EXACT_BUCKET)
def test_exact_bucket_payload_keeps_its_final_token(raw, mode):
    stream = tamp_tpu.compress(raw, window=10, literal=8)
    assert len(stream) - 1 == 64
    assert bytes(_native.native_decompress(stream)) == raw
    if mode == "serial":
        from tamp_tpu_torch.ops.decode_serial import decode_shards_device

        got = decode_shards_device([stream], max_out=4096, device="cpu")
    else:  # commit is also the default mode
        kw = {} if mode == "commit" else {"mode": mode}
        got = twf.decode_shards_wavefront([stream], max_out=4096,
                                          device="cpu", **kw)
    assert got == [raw]

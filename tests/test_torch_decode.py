"""The port's decode (ops/decode_wavefront.py parse + kernel B4's plain
version) against the JAX package's per-bit parse and its decode commit
kernel in interpret mode, on the same payloads.  Exact equality."""

import io

import numpy as np
import pytest
import torch
from torch import profiler as tp

import jax.numpy as jnp

import tamp_tpu
from tamp_tpu import _native
from tamp_tpu._native.stream import NativeCompressor
from tamp_tpu.ops import decode_wavefront as jwf
from tamp_tpu.ops.decode_commit_pallas import commit_decode_batch
from tamp_tpu_torch import trace
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import _build
from tamp_tpu_torch.ops import decode_wavefront as twf
from tamp_tpu_torch.ops.decode_commit import (
    ERR_OK, commit_decode, commit_decode_words, commit_token_words_plain,
    fuse_parse,
)
from test_torch_cuda import EXACT_BUCKET

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


def _group(case):
    """(payloads, window, literal, extended, more) of a case's streams."""
    streams = _cases()[case][0]
    h, payloads = _payloads(streams)
    return (payloads, (h >> 5) + 8, ((h >> 3) & 3) + 5, bool((h >> 1) & 1),
            bool(h & 1))


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if a kernel launch is attempted."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(_build, "launch", refuse)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", range(6))
def test_cpu_parse_words_is_the_plain_version(case, fused, no_launch):
    # CPU tensors take the tensor ops, counted as no launch: the fused
    # plane is fuse_parse of speculative_parse, the pair its packing
    payloads, window, literal, extended, _more = _group(case)
    before = twf.parse_words.launches
    got = twf.payload_parse(payloads, window=window, literal=literal,
                            extended=extended, device="cpu", fused=fused)
    assert twf.parse_words.launches == before
    L = twf._pow2_bucket(max(len(p) for p in payloads) + 1, 64)
    pp = np.zeros((len(payloads), L + 8), np.int64)
    for i, p in enumerate(payloads):
        pp[i, : len(p)] = np.frombuffer(p, np.uint8)
    nb = torch.tensor([8 * len(p) for p in payloads], dtype=torch.int32)
    nxt, kind, cnt, idx = twf.speculative_parse(
        torch.from_numpy(pp), nb, 8 * L, window, literal, extended)
    packed = kind | (cnt << 3) | (idx << 11)
    if fused:
        assert torch.equal(got, fuse_parse(nxt, packed))
    else:
        assert torch.equal(got[0], nxt) and torch.equal(got[1], packed)


@pytest.mark.parametrize("case", range(7))
def test_commit_decode_words_equals_commit_decode(case, no_launch):
    # B4's entry on the fused plane gives commit_decode's result on the
    # pair, errors included
    payloads, window, literal, extended, more = _group(case)
    _s, d_init, d_reset, max_out = _cases()[case]
    kw = dict(window=window, literal=literal, extended=extended,
              device="cpu")
    nxt, packed = twf.payload_parse(payloads, **kw)
    pk = twf.payload_parse(payloads, fused=True, **kw)
    di, dr = torch.from_numpy(d_init.copy()), torch.from_numpy(d_reset.copy())
    ck = dict(W=1 << window, more=more, max_out=max_out)
    for got, want in zip(commit_decode_words(pk, di, dr, **ck),
                         commit_decode(nxt, packed, di, dr, **ck)):
        assert torch.equal(got, want)


def _parse_args(L=64, S=2):
    pp = torch.zeros((S, L + 16), dtype=torch.uint8)
    pp[:, :5] = 0xA5
    return dict(pp=pp, nbytes=torch.full((S,), 5, dtype=torch.int32),
                NBP=8 * L)


PARSE_REFUSALS = {
    "pp not uint8": lambda a: a.update(pp=a["pp"].to(torch.int64)),
    "pp one row": lambda a: a.update(pp=a["pp"][0]),
    "nbytes not int32": lambda a: a.update(
        nbytes=a["nbytes"].to(torch.int64)),
    "nbytes of another S": lambda a: a.update(nbytes=a["nbytes"][:1]),
    "NBP not a multiple of 8": lambda a: a.update(NBP=a["NBP"] - 4),
    "NBP zero": lambda a: a.update(NBP=0),
    "rows too short": lambda a: a.update(pp=a["pp"][:, :64].contiguous()),
    "rows not a multiple of 16": lambda a: a.update(
        pp=a["pp"][:, :76].contiguous()),
    "devices differ": lambda a: a.update(
        nbytes=torch.empty(2, dtype=torch.int32, device="meta")),
    "unsupported device": lambda a: a.update(
        pp=a["pp"].to("meta"), nbytes=a["nbytes"].to("meta")),
}


@pytest.mark.parametrize("case", list(PARSE_REFUSALS))
def test_parse_words_refuses_before_any_launch(case, no_launch):
    a = _parse_args()
    ok = twf.parse_words(**a, window=10, literal=8, extended=True,
                         fused=True)
    assert ok.shape == (2, a["NBP"])
    PARSE_REFUSALS[case](a)
    before = twf.parse_words.launches
    with pytest.raises(ValueError):
        twf.parse_words(a.pop("pp"), a.pop("nbytes"), a.pop("NBP"),
                        window=10, literal=8, extended=True, fused=True)
    assert twf.parse_words.launches == before


WORDS_REFUSALS = {
    "pk not int32": lambda a: a.update(pk=a["pk"].to(torch.int64)),
    "pk one row": lambda a: a.update(pk=a["pk"][0]),
    "dictionary of another W": lambda a: a.update(di=a["di"][:512]),
    "dictionary not uint8": lambda a: a.update(di=a["di"].to(torch.int32)),
    "devices differ": lambda a: a.update(di=a["di"].to("meta")),
    "unsupported device": lambda a: a.update(
        pk=a["pk"].to("meta"), di=a["di"].to("meta"),
        dr=a["dr"].to("meta")),
    "min_bits below 1": lambda a: a.update(min_bits=0),
}


@pytest.mark.parametrize("case", list(WORDS_REFUSALS))
def test_commit_decode_words_refuses_before_any_launch(case, no_launch):
    d = torch.from_numpy(dictionary_array(1024, literal=8))
    a = dict(pk=torch.zeros((2, 512), dtype=torch.int32), di=d, dr=d)
    WORDS_REFUSALS[case](a)
    with pytest.raises(ValueError):
        commit_decode_words(a["pk"], a["di"], a["dr"], W=1024, more=False,
                            max_out=1024, min_bits=a.get("min_bits", 1))


def test_parse_bits_counted_only_while_tracing():
    payloads, window, literal, extended, _more = _group(0)
    kw = dict(window=window, literal=literal, extended=extended,
              device="cpu")
    NBP = 8 * twf._pow2_bucket(max(len(p) for p in payloads) + 1, 64)
    trace.reset()
    twf.payload_parse(payloads, fused=True, **kw)
    assert "decode.parse_bits" not in trace.snapshot().counters
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        twf.payload_parse(payloads, fused=True, **kw)
        twf.payload_parse(payloads, **kw)
    counters = trace.snapshot().counters
    trace.reset()
    assert counters["decode.parse_bits"] == 2 * len(payloads) * NBP



@pytest.mark.parametrize("mode", ["commit", "chase"])
def test_commit_tokens_counted_only_while_tracing(mode, no_launch):
    # B4's front counts its complete tokens in the decode's d2h span, from
    # its T: only while tracing and only in mode commit
    streams = _cases()[0][0]
    tokens = sum(int(commit_token_words_plain(twf.payload_parse(
        [s[1:]], window=10, literal=8, extended=True, device="cpu",
        fused=True))[1].sum()) for s in streams)
    assert tokens > 0
    trace.reset()
    twf.decode_shards_wavefront(streams, max_out=4096, device="cpu",
                                mode=mode)
    assert "decode.commit_tokens" not in trace.snapshot().counters
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        back = twf.decode_shards_wavefront(streams, max_out=4096,
                                           device="cpu", mode=mode)
    snap = trace.snapshot()
    trace.reset()
    assert back == [tamp_tpu.decompress(s) for s in streams]
    want = tokens if mode == "commit" else None
    assert snap.counters.get("decode.commit_tokens") == want
    d2h = [s for s in snap.spans if s.name == "tamp.decode.d2h"]
    assert d2h

"""The plain reference against the port's host codec (the Python streaming
codec, which reproduces the reference encoder), and against the port's
containers made on the plain versions of its kernels."""

from __future__ import annotations

import json
import random

import pytest

from portbench.harness import spec
from portbench.reference import check, tamp_plain as T

CORPUS = spec.load_module(spec.BENCH / "corpora" / "zipf-text.py",
                          "t_corpus")
TEXT = json.loads((spec.BENCH / "configs" / "tamp-ext-w10-l8.json")
                  .read_text())["assumed"]["corpus"]


def _cases():
    rng = random.Random(3)
    out = [b"", b"a", b"aaaa", b"ab" * 50, bytes(300),
           bytes(range(256)) * 9]
    out += CORPUS.make_inputs(TEXT, 11, 3, 1, 3000)
    out += [bytes(rng.choice(b"ab\x00 ") for _ in range(2500))]
    out += [bytes([rng.randrange(256)]) * rng.randrange(1, 600)
            + bytes(rng.randrange(256) for _ in range(rng.randrange(50)))
            for _ in range(6)]
    # a long match held past the ring's end, and a run at it
    out += [bytes(range(256)) * 4 + bytes(range(200)) * 3,
            b"x" * 1020 + b"y" * 300]
    return out


CASES = _cases()


@pytest.mark.parametrize("extended", [True, False])
@pytest.mark.parametrize("window", [8, 10, 12])
def test_encode_equals_the_host_codec(window, extended):
    from tamp_tpu_torch.compressor import compress

    for data in CASES:
        got = T.encode(data, window=window, extended=extended)
        assert got == compress(data, window=window, extended=extended)
        assert T.decode(got) == data


@pytest.mark.parametrize("literal", [5, 7])
def test_narrow_literals(literal):
    from tamp_tpu_torch.compressor import compress

    data = bytes(b & ((1 << literal) - 1) for b in CASES[6])
    got = T.encode(data, literal=literal)
    assert got == compress(data, literal=literal)
    assert T.decode(got) == data
    with pytest.raises(ValueError):
        T.encode(b"\xff", literal=literal)


def test_dictionary_is_the_formats():
    from tamp_tpu_torch.dictionary import initialize_dictionary

    for w, lit in ((8, 8), (10, 8), (10, 6), (12, 5)):
        assert T.dictionary(w, lit) == initialize_dictionary(1 << w,
                                                             literal=lit)


def test_decode_refuses_what_it_does_not_read():
    with pytest.raises(ValueError):
        T.decode(b"")
    with pytest.raises(ValueError):
        T.decode(bytes([0b01000110]))  # a custom dictionary
    stream = T.encode(CASES[6])
    refused = 0
    for cut in range(len(stream) // 2, len(stream) // 2 + 8):
        try:  # a cut at a token's end reads as a shorter stream
            assert CASES[6].startswith(T.decode(stream[:cut]))
        except ValueError:
            refused += 1
    assert refused


@pytest.mark.parametrize("extended", [True, False])
def test_the_ports_container_checks_clean(extended):
    from tamp_tpu_torch.parallel.shard import compress_sharded

    data = CORPUS.make_inputs(TEXT, 5, 1, 3, 4096)[0][:10000]
    blob = compress_sharded(data, extended=extended, shard_size=4096,
                            device="cpu")
    ver, raw, ss, streams = T.parse_frame(blob)
    assert (ver, raw, ss, len(streams)) == (2, len(data), 4096, 3)
    res = check.check_encode([(data, blob)], window=10, literal=8,
                             extended=extended, shard_bytes=4096, sample=3,
                             seed=1)
    assert all(v == 0 for v, _lim in res.values()), res
    assert T.decode(streams[2]) == data[8192:]


def test_frame_faults_and_diff():
    data = b"abc" * 2000
    blob = bytearray(b"TTPU" + bytes([2, 0]) + (1).to_bytes(4, "little")
                     + len(data).to_bytes(8, "little")
                     + (8192).to_bytes(8, "little"))
    stream = T.encode(data)
    blob += len(stream).to_bytes(4, "little") + stream
    assert check._frame(bytes(blob), data, 8192) == (0, [stream])
    assert check._frame(bytes(blob), data, 4096) == (2, None)
    assert check._frame(bytes(blob[:-1]), data, 8192) == (1, None)
    assert check._frame(b"TTPX" + bytes(blob[4:]), data, 8192) == (1, None)
    assert check.diff(b"abcd", b"abXdef") == 3


def test_decode_control_breaks_the_runs():
    data = CORPUS.make_inputs(TEXT, 9, 1, 1, 8192)[0]
    stream = T.encode(data)
    assert T.decode(stream) == data
    assert check.diff(T.decode(stream, rle_window=255), data) > 0


def _walk_tokens(stream):
    """(tokens, matches) of a stream by a walk over its bits as text, one
    token at a time (FLUSH tokens not counted)."""
    head = stream[0]
    window, literal = (head >> 5) + 8, ((head >> 3) & 3) + 5
    extended = bool(head & 2)
    bits = "".join(f"{b:08b}" for b in stream[1:])
    first = {format(c, f"0{n}b"): s for s, (c, n) in enumerate(
        zip(T.HUFFMAN_CODES, T.HUFFMAN_LENGTHS))}
    second = {k[1:]: s for k, s in first.items()}

    def symbol(at, table):
        for n in range(1, 10):
            if bits[at:at + n] in table:
                return table[bits[at:at + n]], n
        return None, 0

    at = tokens = matches = 0
    while at < len(bits):
        if bits[at] == "1":
            size, kind = 1 + literal, "literal"
        else:
            s, n = symbol(at, first)
            if s is None:
                break
            if s == T.FLUSH_SYMBOL:
                at = (at + n + 7) & ~7
                continue
            if extended and s in (T.RLE_SYMBOL, T.EXT_SYMBOL):
                _s2, n2 = symbol(at + n, second)
                if _s2 is None:
                    break
                size = n + n2 + (T.RLE_BITS if s == T.RLE_SYMBOL
                                 else T.EXT_BITS + window)
                kind = "rle" if s == T.RLE_SYMBOL else "match"
            else:
                size, kind = n + window, "match"
        if at + size > len(bits):
            break
        at += size
        tokens += 1
        matches += kind == "match"
    assert len(bits) - at < 8
    return tokens, matches


@pytest.mark.parametrize("extended", [True, False])
@pytest.mark.parametrize("window,literal", [(8, 8), (10, 8), (12, 7),
                                            (15, 5)])
def test_count_tokens_equals_a_walk_over_the_bits(window, literal, extended):
    mask = (1 << literal) - 1
    for data in CASES:
        stream = T.encode(bytes(b & mask for b in data), window=window,
                          literal=literal, extended=extended)
        assert T.count_tokens(stream) == _walk_tokens(stream)


def test_count_tokens_past_a_flush_and_refusals():
    from tamp_tpu_torch.compressor import Compressor
    import io

    buf = io.BytesIO()
    c = Compressor(buf)
    c.write(CASES[6][:1500])
    c.flush()
    c.write(CASES[6][1500:])
    c.flush(write_token=False)
    stream = buf.getvalue()
    assert T.decode(stream) == CASES[6]
    got = T.count_tokens(stream)
    assert got == _walk_tokens(stream) and got[0] > got[1] > 0
    assert T.count_tokens(stream[:1]) == (0, 0)
    with pytest.raises(ValueError):
        T.count_tokens(b"")
    refused = 0
    for cut in range(2, len(stream), 7):  # refused exactly where decode is
        try:
            T.decode(stream[:cut])
        except ValueError:
            refused += 1
            with pytest.raises(ValueError):
                T.count_tokens(stream[:cut])
        else:
            T.count_tokens(stream[:cut])
    assert refused

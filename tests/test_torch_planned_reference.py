"""The benchmark's plain planned encoder (portbench/reference/tamp_planned.py)
against the program: each case's stream byte-equal to the port's
``compress_sharded(engine="device-commit", device="cpu")`` shard and to the
JAX package's native planned committer, and read back by the plain
decoder.  The cases cover every rule of the planned walk (the reference
counts the rules that fired)."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

from portbench.reference import tamp_planned as P
from portbench.reference import tamp_plain as T
from tamp_tpu import _native
from tamp_tpu_torch.parallel.shard import compress_sharded

from test_torch_pipeline_ext import native_planned

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")

RULES = ("match_cut_at_plan", "rle_split", "rle_split_room_1",
         "ext_to_ring_end", "ext_as_basic")


def _mix(seed: int, n: int, literal: int) -> bytes:
    """Seeded bytes of text, runs (planned and not), copies and periods."""
    rng = np.random.default_rng(seed)
    mask = (1 << literal) - 1
    out = bytearray()

    def rand(lo, hi, k):
        return bytes(int(x) & mask for x in rng.integers(lo, hi, k))

    while len(out) < n:
        kind = int(rng.integers(0, 6))
        if kind == 0:  # a short run: the dynamic RLE
            out += rand(0, 256, 1) * int(rng.integers(2, 12))
        elif kind == 1:  # a planned run, one chunk or several
            out += rand(0, 256, 1) * int(rng.integers(9, 600))
        elif kind == 2 and len(out) > 40:  # a copy: long matches
            a = int(rng.integers(0, len(out) - 20))
            out += out[a : a + int(rng.integers(3, 200))]
        elif kind == 3:
            out += rand(97, 105, int(rng.integers(1, 30)))
        elif kind == 4:  # a period: extended matches across the ring end
            out += rand(0, 256, int(rng.integers(1, 20))) \
                * int(rng.integers(2, 40))
        else:
            out += rand(0, 256, int(rng.integers(1, 8)))
    return bytes(out[:n])


def _text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, int(k)).astype(np.uint8))
             for k in rng.integers(2, 8, 40)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 40, n))[:n]


def _cases():
    out = []
    for window, literal, n in ((8, 6, 3000), (8, 7, 3000), (8, 8, 3000),
                               (10, 6, 3000), (10, 7, 3000), (10, 8, 3000),
                               (15, 8, 600)):
        for seed in (1, 2):
            out.append((f"mix-w{window}l{literal}-{seed}", window, literal,
                        _mix(window * 100 + literal * 10 + seed, n,
                             literal)))
    text = _text(7, 1500)
    dlast = P.dictionary(10, 8)[-1]
    out += [
        # a region of 242 bytes: chunks 240 and 2, not 241 and 1
        ("region-242", 10, 8, text[:400] + b"q" * 243 + text[400:800]),
        # a match of text and a run cut at the later run's plan start
        ("cut-at-plan", 10, 8, b"abcdefgh" + b"x" * 12 + text[:300]
         + b"abcdefgh" + b"x" * 20 + text[300:600]),
        # a shard that opens with a planned run of the dictionary's last
        # byte (the run stops at the first chunk start)
        ("dict-byte-run-first", 10, 8, bytes([dlast]) * 40 + text[:300]),
        # a run of 5 met with 1 and with 3 bytes left before the ring end
        # ('z' is in neither the text nor the dictionary, so the run's
        # first byte is a literal at W - 2 or W - 4)
        ("rle-split-room-1", 8, 8, text[:254] + b"z" * 6 + text[:200]),
        ("rle-split-room-3", 10, 8, text[:1019] + b"z" * 6 + text[:200]),
        ("short-15", 10, 8, text[:15]),
        ("short-1", 8, 6, b"\x21"),
        ("empty", 10, 8, b""),
    ]
    return out


CASES = _cases()


def _port(data: bytes, window: int, literal: int) -> bytes:
    blob = compress_sharded(data, window=window, literal=literal,
                            extended=True, engine="device-commit",
                            shard_size=1 << 16, device="cpu")
    streams = T.parse_frame(blob)[3]
    assert len(streams) == 1
    return streams[0]


@pytest.mark.parametrize("name,window,literal,data", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_equals_the_program(name, window, literal, data):
    ref = P.encode(data, window=window, literal=literal)
    assert ref == _port(data, window, literal)
    assert ref == native_planned(data, window, literal)
    assert T.decode(ref) == data


def test_the_cases_cover_every_rule():
    seen: dict = {}
    for _name, window, literal, data in CASES:
        P.encode(data, window=window, literal=literal, events=seen)
    assert set(RULES) <= set(seen), seen
    # a forced region whose last chunk would have left a single byte
    assert any((e - s) > 241 and (e - s) % 241 == 1
               for _n, w, _l, d in CASES for s, e in P.model(d, w)[0])
    sizes = [len(c[3]) for c in CASES]
    assert 0 in sizes and any(0 < n < 16 for n in sizes)


def test_the_reference_imports_nothing_of_the_program():
    path = Path(P.__file__)
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "numpy"}, tops

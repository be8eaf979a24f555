"""Kernels of the port on an NVIDIA card against their plain versions.

Needs a CUDA device; skips without one.  Imports nothing of JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import os

import numpy as np
import pytest
import torch

from tamp_tpu_torch.constants import (
    EXTENDED_MATCH_SYMBOL, EXTENDED_MATCH_TRAILING_BITS, FLUSH_SYMBOL,
    HUFFMAN_CODES, HUFFMAN_LENGTHS, RLE_SYMBOL, RLE_TRAILING_BITS,
    compute_min_pattern_size,
)
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_commit as dc
from tamp_tpu_torch.ops import decode_serial as dser
from tamp_tpu_torch.ops import decode_wavefront as dw
from tamp_tpu_torch.engine.greedy import (
    SPARSE_NONE, greedy_compress, host_v1_tables,
)
from tamp_tpu_torch.engine.pipeline_ext import (
    encode_ext_device_greedy, optimal_batch, optimal_prep,
)
from tamp_tpu_torch.ops.greedy_predict import (
    greedy_predict_batch, greedy_predict_plain, pack_predict_plane,
)
from tamp_tpu_torch.ops.token_chase import (
    token_table_chase, token_table_chase_plain,
)
from tamp_tpu_torch.ops.encode_commit import (
    commit_fields, commit_fields_plain, commit_v1_lazy, commit_v1_lazy_plain,
)
from tamp_tpu_torch.ops.match_ext import (
    ext_tables, ext_tables_plain, ext_tables_probe, ext_tables_probe_plain,
)
from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
from tamp_tpu_torch.ops.opt_parse import (
    B_V1, INF, opt_v1_choice, opt_v1_choice_plain,
)
from tamp_tpu_torch.ops.opt_parse_ext import (
    opt_ext_choice, opt_ext_choice_plain,
)
from tamp_tpu_torch.ops.encode_fused import v1_cap
from tamp_tpu_torch.parallel.shard import (
    _pack_frame, _parse_frame, compress_sharded, decompress_sharded_device,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 8)))
             for _ in range(64)]
    s = b" ".join(words[int(i)] for i in rng.integers(0, 64, n))[:n]
    return s[: n // 2] + b"=" * 300 + s[n // 2 :]


class _Bits:
    """MSB-first bit writer for hand-built Tamp streams."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, v: int, n: int):
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def align(self):
        self.bits.extend([0] * (-len(self.bits) % 8))

    def bytes(self) -> bytes:
        self.align()
        return bytes(int("".join(map(str, self.bits[i : i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def hazard_stream(seed: int, window: int, *, more: bool = False,
                  n_tokens: int = 1500, literal: int = 8, oob_at: int = -1,
                  spans: list | None = None):
    """A seeded random valid extended Tamp stream aimed at the decode
    commit's hazards: literal runs; basic matches into the last 1-64 ring
    bytes written (so many read bytes of the previous few tokens, and many
    hold the write head); RLE up to its longest (241); extended matches
    that pass the ring end when they can; on a ``more`` stream FLUSH and
    double FLUSH tokens.  ``oob_at``: token index of a match that reads past
    the window (ERR_OOB), which ends the stream.  Returns (stream, decoded
    length up to the OOB token).  ``spans``, if given, gets (kind, output
    offset, size) of every match, RLE and extended match token."""
    HC, HL = HUFFMAN_CODES, HUFFMAN_LENGTHS
    ET, RT = EXTENDED_MATCH_TRAILING_BITS, RLE_TRAILING_BITS
    rng = np.random.default_rng(seed)
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    bw = _Bits()
    bw.put(((window - 8) << 5) | ((literal - 5) << 3) | 2 | int(more), 8)
    if more:
        bw.put(0, 8)  # reserved header byte
    pos = out = 0  # the ring head and the output length
    lwf = False
    for k in range(n_tokens):
        r = rng.random()
        if k == oob_at:
            bw.put(HC[11], HL[11])
            bw.put(W - 2, window)
            break
        if more and r < 0.05:  # FLUSH, often twice: the ring resets
            for _ in range(1 + int(rng.random() < 0.6)):
                bw.put(HC[FLUSH_SYMBOL], HL[FLUSH_SYMBOL])
                bw.align()
                pos = 0 if lwf else pos
                lwf = True
            continue
        lwf = False
        if r < 0.35:  # literal
            bw.put((1 << literal) | int(rng.integers(0, 1 << literal)),
                   literal + 1)
            cnt = wr = 1
        elif r < 0.7:  # basic match, mostly into the last 64 ring bytes
            sym = int(rng.integers(0, 12))
            cnt = wr = sym + minp
            kind = "match"
            d = int(rng.integers(1, 65 if r < 0.62 else W))
            bw.put(HC[sym], HL[sym])
            bw.put(min((pos - d) % W, W - cnt), window)
        elif r < 0.84:  # RLE of 2..241 bytes
            s2, trail = int(rng.integers(0, 15)), int(rng.integers(0, 16))
            cnt = (s2 << RT) + trail + 2
            wr = min(cnt, 8, W - pos)
            kind = "rle"
            bw.put(HC[RLE_SYMBOL], HL[RLE_SYMBOL])
            bw.put(HC[s2], HL[s2] - 1)
            bw.put(trail, RT)
        else:  # extended match, past the ring end when it can
            lo, hi = minp + 12, minp + 12 + (14 << ET) + 7
            cnt = int(rng.integers(lo, hi + 1))
            if W - pos <= hi and rng.random() < 0.7:
                cnt = int(rng.integers(max(lo, W - pos), hi + 1))
            wr = min(cnt, W - pos)
            kind = "ext"
            v = cnt - lo
            d = int(rng.integers(1, 65))
            bw.put(HC[EXTENDED_MATCH_SYMBOL], HL[EXTENDED_MATCH_SYMBOL])
            bw.put(HC[v >> ET], HL[v >> ET] - 1)
            bw.put(v & ((1 << ET) - 1), ET)
            bw.put(min((pos - d) % W, W - cnt), window)
        if spans is not None and cnt > 1:
            spans.append((kind, out, cnt))
        pos = (pos + wr) % W
        out += cnt
    return bw.bytes(), out


def hazard_fields(seed: int, S: int, NP: int, idx_bits: int):
    """Seeded random planned fields (A, B) as int32 arrays, in the ranges
    ops/plan_ext.py produces (fields of 1-24 bits, advances mostly 1-3 and
    up to 255, at windows 14 and 15 a split index on 30 % of them), with the
    hazards of the tile-parallel fields commit: an error field in the middle
    of a tile (row 1), a zero advance in the middle of a tile (row 2), a row
    of values wider than their fields (row 3, the excess-bits error field's
    shape)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(1, 25, (S, NP))
    adv = np.where(rng.random((S, NP)) < 0.8, rng.integers(1, 4, (S, NP)),
                   rng.integers(1, 256, (S, NP)))
    A = rng.integers(0, 1 << 24, (S, NP)) & ((1 << nb) - 1)
    B = nb | (adv << 6)
    if idx_bits:
        B |= ((rng.random((S, NP)) < 0.3) << 15) \
            | (rng.integers(0, 1 << idx_bits, (S, NP)) << 16)
    if S > 1:
        B[1, NP // 2 + 37 :] |= 1 << 14
    if S > 2:
        B[2, NP // 3 + 11 :] &= ~(255 << 6)
    if S > 3:
        A[3] = rng.integers(0, 1 << 24, NP)
    return A.astype(np.int32), B.astype(np.int32)


def _probe_off_head(t, W):
    """A probe source index whose 16-byte span does not hold t & (W - 1)."""
    return ((t & (W - 1)) + 16) & (W - 1)


def hazard_lazy_tables(seed: int, S: int, NP: int, window: int, literal: int,
                       tile: int = 4096):
    """Seeded random lazy v1 tables (P = len << 23 | idx << 8 | byte, Q =
    plen << 15 | pidx, int32 arrays) and lengths npos, with the hazards of
    the tile-parallel lazy walk: runs of short matches each beaten by a
    longer probe away from the write head (deferral chains) across every
    ``tile`` seam; in row 1 a deferral whose literal is an excess byte and
    in row 2 an excess literal, both mid-tile (when ``literal`` < 8); in row
    3 deferred probe sizes of 300, 4000 and 65535 (jumps across tiles and
    past the end); in row 4 a deferral at npos - 16, so the walk stops with
    its cache set; row 5 has npos < 16.  S >= 6."""
    rng = np.random.default_rng(seed)
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    lit = 256 if literal == 8 else 1 << literal
    size = np.where(rng.random((S, NP)) < 0.5, 0,
                    rng.integers(minp, 17, (S, NP)))
    idx = rng.integers(0, W, (S, NP))
    byte = rng.integers(0, lit, (S, NP))
    psz = rng.integers(0, 16, (S, NP))
    pix = rng.integers(0, W, (S, NP))
    t_all = np.arange(NP)
    chain = minp + 1 + t_all % (10 - minp)  # minp + 1 .. 9, then again
    for seam in range(tile, NP, tile):
        sl = slice(seam - 40, seam + 40)
        size[:, sl] = minp
        psz[:, sl] = chain[sl]
        pix[:, sl] = _probe_off_head(t_all[sl], W)

    def lead_in(s, t):  # literals up to t, so the walk lands on t
        size[s, t - 24 : t + 1] = 0
        psz[s, t - 24 : t + 1] = 0

    def defer_at(s, t, n):  # a deferral at t to a probe of n bytes
        lead_in(s, t)
        size[s, t] = minp
        psz[s, t] = n
        pix[s, t] = _probe_off_head(t, W)

    mid = tile // 2 + 37
    if literal < 8:
        defer_at(1, mid, minp + 1)
        byte[1, mid] = 0xC3 | lit
        lead_in(2, tile + mid)
        byte[2, tile + mid] = 0xF1 | lit
    for t, n in ((mid, 300), (tile + mid, 4000), (2 * tile + mid, 65535)):
        defer_at(3, t, n)
    npos = np.full(S, NP)
    npos[4] = NP - 1000
    defer_at(4, npos[4] - 16, minp + 1)
    npos[5] = 15
    P = (size << 23) | (idx << 8) | byte
    Q = (psz << 15) | pix
    return P.astype(np.int32), Q.astype(np.int32), npos.astype(np.int32)


def hazard_predict_planes(seed: int, S: int, NP: int, window: int,
                          literal: int, tile: int = 4096):
    """Seeded random greedy walker planes (pk = idx16 | ln << 15 | run << 20,
    pp = pidx | plen << 15, int32 arrays) and lengths npos, with the hazards
    of the tile-parallel replay: runs of 255 equal bytes (RLE advances of
    241) across every ``tile`` seam; in row 1 no entry at all (every length
    below minp); short matches beaten by a probe away from the write head
    (lazy deferrals) in row 2; row 3 stops mid-tile; row 4 has npos < 16.
    S >= 5."""
    rng = np.random.default_rng(seed)
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    ln = np.where(rng.random((S, NP)) < 0.5, rng.integers(0, minp, (S, NP)),
                  rng.integers(minp, 17, (S, NP)))
    run = np.where(rng.random((S, NP)) < 0.8, 0, rng.integers(0, 256, (S, NP)))
    idx = rng.integers(0, 1 << 15, (S, NP))
    plen = rng.integers(0, 16, (S, NP))
    pidx = rng.integers(0, W, (S, NP))
    for seam in range(tile, NP, tile):
        run[:, seam - 300 : seam + 20] = 255
    ln[1] = rng.integers(0, minp, NP)
    t_all = np.arange(NP)
    short = rng.random(NP) < 0.5
    ln[2, short] = rng.integers(minp, 9, int(short.sum()))
    run[2, short] = 0
    plen[2, short] = 15
    pidx[2, short] = _probe_off_head(t_all[short], W)
    npos = np.full(S, NP)
    npos[3] = NP - tile // 2 - 123
    npos[4] = 12
    pk = idx | (ln << 15) | (run << 20)
    pp = pidx | (plen << 15)
    return pk.astype(np.int32), pp.astype(np.int32), npos.astype(np.int32)


def hazard_nxt(seed: int, S: int, NBP: int, *, min_hop: int = 1,
               tile: int = 4096, long_hop: bool = False):
    """Seeded random per-bit jump planes (S, NBP) int32 with the hazards of
    the tile-parallel chase: off the orbit every bit hops ``min_hop``..34
    bits; on the orbit, wherever a 512-bit seam is in reach, the hop
    crosses it by 0..33 bits, and in row 0 it lands exactly on the first
    bit of every ``tile``.  The orbit ends with an incomplete token (nxt ==
    NBP) in the last tile (rows 0, 5 and on), in the first tile (row 1) and
    mid-row (row 2); row 3 has a hop that does not advance mid-row and row
    4 no token at all.  With ``long_hop`` the orbit of row 5 hops 100 bits
    past the end of its first tile, which no parse makes (the kernel's maps
    keep 64 entry bits).  S >= 6."""
    rng = np.random.default_rng(seed)
    b = np.arange(NBP)
    nxt = np.minimum(b + rng.integers(min_hop, 35, (S, NBP)), NBP)
    for r in range(S):
        c, far = 0, long_hop and r == 5
        while True:
            seam = (c // 512 + 1) * 512
            if far and seam % tile == 0 and seam - c <= 34:
                n, far = seam + 100, False
            elif min_hop <= seam - c <= 34:
                n = seam if r == 0 and seam % tile == 0 else \
                    seam + int(rng.integers(0, 35 - (seam - c)))
            else:
                n = c + int(rng.integers(min_hop, 35))
            if n >= NBP:
                nxt[r, c] = NBP
                break
            nxt[r, c] = n
            c = n
    for r, at in ((1, tile // 2), (2, NBP // 2), (3, NBP // 3)):
        c = 0
        while c < at and nxt[r, c] < NBP:
            c = int(nxt[r, c])
        nxt[r, c] = NBP if r < 3 else c - int(rng.integers(0, 6))
    nxt[4, 0] = NBP
    return nxt.astype(np.int32)


def _de_bruijn_pairs(k: int) -> np.ndarray:
    """A sequence over 0..k-1 of length k * k + 1 holding every ordered
    pair once (an Euler path through the pairs)."""
    seq, used = [0], set()
    while len(seq) < k * k + 1:
        a = seq[-1]
        nb = next((x for x in range(k - 1, -1, -1) if (a, x) not in used),
                  None)
        if nb is None:
            break
        used.add((a, nb))
        seq.append(nb)
    return np.asarray(seq)


def hazard_rows(seed: int, S: int, NP: int, window: int):
    """Seeded random raw rows (S, NP) uint8 and lengths npos with the
    hazards of the filtered match tables: row 0 all-equal bytes (runs to
    the cap, the glue at the head); rows 1-3 periods W - 1, W and W + 1
    (the glue diagonals); row 4 a 15- and a 16-byte match to one target
    (tied at cap 15, not at 16); row 5 bytes whose every pair occurs once,
    so most positions match one byte and no more; row 6 text with a
    probe match planted at tau = W - 1 and npos not a multiple of the
    256-position block; row 7 npos < 17.  S >= 8."""
    rng = np.random.default_rng(seed)
    W = 1 << window
    words = [rng.integers(97, 104, rng.integers(2, 7)).astype(np.uint8)
             for _ in range(40)]
    text = np.concatenate([np.append(words[int(i)], 32)
                           for i in rng.integers(0, 40, NP)])[:NP]
    data = np.tile(text, (S, 1))
    data[0] = 0x20
    for r, period in ((1, W - 1), (2, W), (3, W + 1)):
        data[r] = np.resize(rng.integers(97, 101, period), NP)
    x = rng.integers(128, 256, 16)
    filler = rng.integers(32, 64, 200)
    tie = np.concatenate([x[:15], [1], filler[:24], x, filler[24:84], x,
                          filler[84:]])[:NP]
    data[4, : tie.shape[0]] = tie
    data[5] = np.resize(128 + _de_bruijn_pairs(64), NP)
    if NP > W + 16:
        data[6, W : W + 12] = data[6, W - 200 : W - 188]
    npos = np.full(S, NP)
    npos[6] = NP - 37
    npos[7] = 12
    return data.astype(np.uint8), npos.astype(np.int32)


def _plant(row, dst, src, n):
    """Copy row[src : src + n] to row[dst : dst + n] byte by byte (an
    overlapping copy repeats the period dst - src) and break the run after
    it."""
    for k in range(n):
        row[dst + k] = row[src + k]
    row[dst + n] = row[src + n] ^ 0x40


def hazard_rows_ext(seed: int, S: int, NP: int, window: int,
                    lext: int = 133):
    """Seeded random model-history rows (S, NP) uint8 and lengths npos with
    the hazards of the long family (runs to ``lext``) on top of
    :func:`hazard_rows`' rows 0-7: rows 8-11 random bytes with a repeat of
    17 and 40, of lext - 1, of lext, and of lext + 20 bytes; row 12 a
    target at NP - 150 whose 16-byte match sits at a lower ring slot than
    its 40-byte one (the families pick different slots); row 13 two equal
    50-byte matches to one target (a tie that ring order settles); rows
    14-15 periods W - 100 and W - lext + 1 (the glue inside a long run);
    row 16 period 64, which divides W, so every candidate's run crosses the
    head, with npos off the 256-position block; row 17 all-equal bytes with
    npos < lext.  S >= 18, NP >= W + 300.  chip_smoke.py holds a copy."""
    W = 1 << window
    data, npos = hazard_rows(seed, S, NP, window)
    rng = np.random.default_rng(seed + 1)
    for r in range(8, 14):
        data[r] = rng.integers(32, 127, NP)
    _plant(data[8], NP - 260, NP - 260 - 100, 17)
    _plant(data[8], NP - 200, NP - 200 - (W - 30), 40)
    _plant(data[9], NP - 300, NP - 300 - 150, lext - 1)
    _plant(data[10], NP - 300, NP - 300 - (W - 1), lext)
    _plant(data[11], NP - 250, NP - 250 - 160, lext + 20)
    dst = NP - 150
    # slots (ring index p mod W) of the 16- and the 40-byte source
    lo, hi = dst - W + 1, dst - 41
    pb = next(p for p in range(hi, lo, -1) if W // 2 <= p % W <= W - 41)
    pa = next(p for p in range(lo, hi) if p % W < pb % W - 20
              and (p + 17 < pb or p > pb + 41))
    _plant(data[12], dst, pb, 40)
    _plant(data[12], pa, dst, 16)
    pa = next(p for p in range(lo, hi) if p % W < W - 51)
    pb = next(p for p in range(dst - 51, lo, -1) if p % W < W - 51 and
              p > pa + 51)
    _plant(data[13], pa, dst, 50)
    _plant(data[13], pb, dst, 50)
    for r, period in ((14, W - 100), (15, W - lext + 1), (16, 64)):
        data[r] = np.resize(rng.integers(32, 127, period), NP)
    data[17] = 0x41
    npos[16] = NP - 101
    npos[17] = lext - 3
    return data, npos


# text at windows 8, 11 and 15; the hazard rows of hazard_rows_ext (W + 600
# positions) at windows 8, 10 and 12, and 12 also at literal 5 (LEXT 134);
# at 15, where the plain version takes minutes, rows 11, 14 and 15 (the
# longest repeat, the glue periods) of W + 300 positions
_EXT_CASES = [(w, 8, "text") for w in (8, 11, 15)] + [
    (w, lit, "hazards") for w, lit in ((8, 8), (10, 8), (12, 8), (12, 5),
                                       (15, 8))]


def _ext_case(window, literal, rows, seed, n1):
    """(dh, npos, dict, LEXT) of a B1 or B2 case; ``n1``: the second text
    row's npos."""
    W = 1 << window
    lext = compute_min_pattern_size(window, literal) + 131
    if rows == "text":
        rng = np.random.default_rng(seed)
        dh = rng.integers(97, 101, (2, 4096)).astype(np.uint8)
        npos = np.asarray([4096, n1], np.int32)
    else:
        dh, npos = hazard_rows_ext(seed, 18, W + (300 if window == 15
                                                   else 600), window, lext)
        if window == 15:
            dh, npos = dh[[11, 14, 15]], npos[[11, 14, 15]]
    d = torch.from_numpy(dictionary_array(W, literal))
    return torch.from_numpy(dh), torch.from_numpy(npos), d, lext


@pytest.mark.parametrize("window,literal,rows", _EXT_CASES)
def test_b1_kernel_equals_plain(cuda, window, literal, rows):
    dh, npos, d, lext = _ext_case(window, literal, rows, window, 1500)
    want = ext_tables_plain(dh, npos, d, window_bits=window, LEXT=lext)
    got = ext_tables(dh.to(cuda), npos.to(cuda), d.to(cuda),
                     window_bits=window, LEXT=lext)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("window,literal,rows", _EXT_CASES)
def test_b2_kernel_equals_plain(cuda, window, literal, rows):
    dh, npos, d, lext = _ext_case(window, literal, rows, window + 1, 1501)
    want = ext_tables_probe_plain(dh, npos, d, window_bits=window, LEXT=lext)
    got = ext_tables_probe(dh.to(cuda), npos.to(cuda), d.to(cuda),
                           window_bits=window, LEXT=lext)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# text at every window; the hazard rows (W + 600 positions) at windows 8,
# 10 and 12 in every cap and probe; at 15, where the plain version takes
# minutes for all eight rows, rows 1, 3 and 6 (the glue periods W - 1 and
# W + 1, the probe at tau = W - 1) at cap 15 with the probe
_B5_CASES = [(w, c, p, "text") for w in (8, 10, 11, 12, 15)
             for c in (15, 16) for p in (False, True)] + [
    (w, c, p, "hazards") for w in (8, 10, 12) for c in (15, 16)
    for p in (False, True)] + [(15, 15, True, "hazards")]


@pytest.mark.parametrize("window,cap,probe,rows", _B5_CASES)
def test_b5_kernel_equals_plain(cuda, window, cap, probe, rows):
    if rows == "text":
        rng = np.random.default_rng(window * 2 + cap)
        data = torch.from_numpy(rng.integers(97, 100, (2, 4096))
                                .astype(np.uint8))
        data[0, 1000:1300] = 7  # a run: glue zones
        npos = torch.tensor([4096, 1499], dtype=torch.int32)
    else:  # past W, so positions with tau = W - 1 are scored
        data, npos = hazard_rows(window + cap, 8, (1 << window) + 600,
                                 window)
        rows = [1, 3, 6] if window == 15 else range(8)
        data, npos = torch.from_numpy(data[rows]), torch.from_numpy(npos[rows])
    d = torch.from_numpy(dictionary_array(1 << window))
    kw = dict(window_bits=window, cap=cap, probe=probe)
    want = v1_tables_plain(data, npos, d, **kw)
    got = v1_tables(data.to(cuda), npos.to(cuda), d.to(cuda), **kw)
    assert len(got) == len(want) == (4 if probe else 2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _b6_first_tables():
    rng = np.random.default_rng(2)
    S, NP = 3, 4096
    size = rng.integers(0, 17, (S, NP))
    packed = (size << 23) | (rng.integers(0, 1024, (S, NP)) << 8) \
        | rng.integers(0, 128, (S, NP))
    probe = (rng.integers(0, 16, (S, NP)) << 15) | rng.integers(0, 1024,
                                                              (S, NP))
    packed[2, 2480:2520] = 0x41  # literals, then one 0x80+ byte: literal 7
    packed[2, 2500] = 0xC3       # cannot hold it (ERR_EXCESS)
    probe[2, 2480:2520] = 0
    npos = np.array([4096, 2000, 4000])
    return packed, probe, npos


@pytest.mark.parametrize("case", [
    "first", "hazards w10 l8", "hazards w10 l7", "hazards w11 l5",
    "max_out clipped", "max_out clipped, not a multiple of 4"])
def test_b6_kernel_equals_plain(cuda, case):
    if case == "first":
        window, literal = 10, 7
        P, Q, npos = _b6_first_tables()
        NP = P.shape[1]
    else:
        window, literal = {"hazards w10 l7": (10, 7),
                           "hazards w11 l5": (11, 5)}.get(case, (10, 8))
        NP = 3 * 4096 + 512  # tiles of the kernel's 4096 positions, a rest
        P, Q, npos = hazard_lazy_tables(window * 10 + literal, 6, NP, window,
                                        literal)
    P, Q = (torch.from_numpy(x.astype(np.int32)) for x in (P, Q))
    npos = torch.from_numpy(npos.astype(np.int32))
    max_out = {"max_out clipped": 400,
               "max_out clipped, not a multiple of 4": 401}.get(
                   case, NP + NP // 8 + 64)
    kw = dict(window=window, literal=literal, max_out=max_out)
    want = commit_v1_lazy_plain(P, Q, npos, **kw)
    before = commit_v1_lazy.launches
    got = commit_v1_lazy(P.to(cuda), Q.to(cuda), npos.to(cuda), **kw)
    assert commit_v1_lazy.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    st = want[1]
    if case == "first":
        assert st[:, 6].tolist() == [0, 0, 1]
        return
    assert st[3, 0] > NP       # a deferred size of 65535 jumped past the end
    assert st[4, 4] >= 0       # the walk stopped with its cache set
    assert st[5, 0] == 0       # npos < 16: no walk
    if literal < 8:            # an excess literal, deferred and not
        assert st[1:3, 6].tolist() == [1, 1] and st[1, 4] >= 0
    if case.startswith("max_out"):
        assert (st[:, 1] > max_out).any()


def _b3_text_fields():
    rng = np.random.default_rng(1)
    S, NP = 3, 4096
    nb = rng.integers(1, 19, (S, NP))
    adv = rng.integers(1, 20, (S, NP))
    A = rng.integers(0, 1 << 18, (S, NP)) & ((1 << nb) - 1)
    B = nb | (adv << 6)
    B[2, 3000:] |= 1 << 14  # an error field ends the third walk
    npos = np.array([4096, 2000, 4000])
    return A.astype(np.int32), B.astype(np.int32), npos, NP + NP // 8 + 64


def _b3_hazard_fields(idx_bits, max_out=None):
    NP = 3 * 4096 + 512  # tiles of the kernel's 4096 positions, and a rest
    A, B = hazard_fields(idx_bits + 5, 6, NP, idx_bits)
    npos = np.array([NP, NP, NP, NP - 100, 9000, 15])  # 15: no walk
    return A, B, npos, NP + NP // 8 + 64 if max_out is None else max_out


@pytest.mark.parametrize("case", [
    "first", "hazards w10", "hazards w14", "hazards w15",
    "max_out clipped", "max_out clipped, not a multiple of 4"])
def test_b3_kernel_equals_plain(cuda, case):
    if case == "first":
        A, B, npos, max_out = _b3_text_fields()
        idx_bits = 0
    else:
        idx_bits = {"hazards w14": 14, "hazards w15": 15}.get(case, 0)
        max_out = {"max_out clipped": 400,
                   "max_out clipped, not a multiple of 4": 401}.get(case)
        A, B, npos, max_out = _b3_hazard_fields(idx_bits, max_out)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    npos = torch.from_numpy(npos.astype(np.int32))
    kw = dict(max_out=max_out, idx_bits=idx_bits)
    want = commit_fields_plain(A, B, npos, **kw)
    before = commit_fields.launches
    got = commit_fields(A.to(cuda), B.to(cuda), npos.to(cuda), **kw)
    assert commit_fields.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case != "first":
        assert want[1][:, 6].tolist() == [0, 1, 2, 0, 0, 0]
        assert want[1][5, 0] == 0  # npos < 16: no walk
    if case.startswith("max_out"):
        assert (want[1][:, 1] > max_out).any()


def _b4_pair(cuda, streams, window, more, max_out):
    """B4 on the card and its plain version on the parse of ``streams``."""
    skip = 2 if more else 1
    nxt, packed = dw.payload_parse([x[skip:] for x in streams],
                                   window=window, literal=8, extended=True,
                                   device=cuda)
    d = torch.from_numpy(dictionary_array(1 << window)).to(cuda)
    kw = dict(W=1 << window, more=more, max_out=max_out)
    before = dc.commit_decode.launches
    got = dc.commit_decode(nxt, packed, d, d, **kw)
    assert dc.commit_decode.launches == before + 1
    want = dc.commit_decode_plain(dc.fuse_parse(nxt, packed).cpu(), d.cpu(),
                                  d.cpu(), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    return want


@pytest.mark.parametrize("kind", [
    "hazards", "more, double FLUSH", "out of bounds mid-stream",
    "overflow mid-stream", "overflow, not a multiple of 16",
    "trailing incomplete token"])
@pytest.mark.parametrize("window", [8, 10, 15])
def test_b4_kernel_equals_plain(cuda, window, kind):
    more = kind.startswith("more")
    streams, lens = zip(*(hazard_stream(
        window * 10 + i, window, more=more, n_tokens=1500 + 500 * i,
        oob_at=900 + 50 * i if kind.startswith("out of") else -1)
        for i in range(3)))
    max_out = 1 << max(max(lens), 1024).bit_length()
    if kind.startswith("overflow"):
        max_out = min(lens) // 2 & ~15
        max_out += 7 if "not a multiple" in kind else 0
    if kind == "trailing incomplete token":
        streams = [x[:-2] for x in streams]
    out, got_lens, errs = _b4_pair(cuda, list(streams), window, more,
                                   max_out)
    want_err = {"out of bounds mid-stream": dc.ERR_OOB,
                "overflow mid-stream": dc.ERR_OVERFLOW,
                "overflow, not a multiple of 16": dc.ERR_OVERFLOW}
    assert errs.tolist() == [want_err.get(kind, dc.ERR_OK)] * 3
    if kind in ("hazards", "more, double FLUSH"):
        assert got_lens.tolist() == list(lens)


def test_entry_points_round_trip_and_match_plain(cuda):
    data = _text(40000, 2)
    blob = compress_sharded(data, shard_size=16384, engine="device-commit")
    assert blob == compress_sharded(data, shard_size=16384, device="cpu",
                                    engine="device-commit")
    before = dc.commit_decode.launches
    assert bytes(decompress_sharded_device(blob)) == data
    assert dc.commit_decode.launches == before + 1
    assert bytes(decompress_sharded_device(blob, device="cpu")) == data
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    for raw, size in ((b"", 1024), (tiny, 7), (tiny, 17)):
        blob = compress_sharded(raw, shard_size=size, engine="device-commit")
        assert blob == compress_sharded(raw, shard_size=size, device="cpu",
                                        engine="device-commit")
        assert bytes(decompress_sharded_device(blob)) == raw


@pytest.mark.parametrize("kw", [
    {"extended": False}, {"extended": False, "lazy_matching": True},
    {"lazy_matching": True}, {"extended": False, "window": 11, "literal": 5},
])
def test_v1_and_lazy_round_trip_and_match_plain(cuda, kw):
    lmask = (1 << kw.get("literal", 8)) - 1
    data = bytes(b & lmask for b in _text(40000, 4))
    blob = compress_sharded(data, shard_size=16384, engine="device-commit",
                            **kw)
    assert blob == compress_sharded(data, shard_size=16384, device="cpu",
                                    engine="device-commit", **kw)
    assert bytes(decompress_sharded_device(blob)) == data
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    for raw, size in ((b"", 1024), (tiny, 7), (tiny, 17)):
        raw = bytes(b & lmask for b in raw)
        blob = compress_sharded(raw, shard_size=size, engine="device-commit",
                                **kw)
        assert blob == compress_sharded(raw, shard_size=size, device="cpu",
                                        engine="device-commit", **kw)
        assert bytes(decompress_sharded_device(blob)) == raw


@pytest.mark.parametrize("window,literal", [(8, 5), (14, 8)])
def test_custom_dictionary_round_trip(cuda, window, literal):
    rng = np.random.default_rng(window)
    dictionary = bytes(rng.integers(0, 1 << literal, 1 << window)
                       .astype(np.uint8))
    data = bytes(b & ((1 << literal) - 1) for b in _text(20000, 3))
    data += dictionary[:3000]
    blob = compress_sharded(data, window=window, literal=literal,
                            dictionary=dictionary, shard_size=8192,
                            engine="device-commit")
    assert blob == compress_sharded(data, window=window, literal=literal,
                                    dictionary=dictionary, shard_size=8192,
                                    device="cpu", engine="device-commit")
    assert bytes(decompress_sharded_device(blob, dictionary=dictionary)) \
        == data


def _parse(cuda, streams):
    return dw.payload_parse([b[1:] for b in streams], window=10, literal=8,
                            extended=True, device=cuda)


@pytest.mark.parametrize("case", ["text", "hazards", "hazards, hops of 9+",
                                  "hazards, T_max clipped"])
def test_b8_kernel_equals_plain(cuda, case):
    if case == "text":
        blob = compress_sharded(_text(40000, 6), shard_size=16384,
                                engine="device-commit")
        nxt, _packed = _parse(cuda, _parse_frame(blob)[2])
    else:  # NBP a multiple of 512, not of the kernel's 4096-bit tile
        nxt = torch.from_numpy(hazard_nxt(
            len(case), 7, 3 * 4096 + 512,
            min_hop=9 if "9+" in case else 1)).to(cuda)
    NBP = nxt.shape[1]
    T_max = 150 if "clipped" in case else NBP // 9 + 2
    before = token_table_chase.launches
    got = token_table_chase(nxt, NBP, T_max)
    assert token_table_chase.launches == before + 1
    want = token_table_chase_plain(nxt.cpu(), NBP, T_max)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case in ("text", "hazards, hops of 9+"):
        # the xla table's range: hops of 9 bits or more, every hop
        # advancing (not hazard row 3)
        rows = [r for r in range(nxt.shape[0]) if case == "text" or r != 3]
        xla = dw._token_table(nxt[rows], NBP, 8, T_max)
        for x, w in zip(xla, want):
            assert torch.equal(x.cpu(), w[rows])


def test_b8_kernel_raises_on_a_hop_past_its_map(cuda):
    # row 5 hops 100 bits past a tile's end: the plain version follows it,
    # the kernel's maps keep 64 entry bits, so the wrapper must raise and
    # never return a table
    NBP = 3 * 4096 + 512
    nxt = torch.from_numpy(hazard_nxt(5, 6, NBP, long_hop=True)).to(cuda)
    _s, T = token_table_chase_plain(nxt.cpu(), NBP, NBP)
    assert T[5] > 4096 // 34
    with pytest.raises(RuntimeError, match="past"):
        token_table_chase(nxt, NBP, NBP)
    ok = nxt.clone()
    ok[5] = torch.from_numpy(hazard_nxt(5, 6, NBP)[5])
    got = token_table_chase(ok, NBP, NBP)
    for g, w in zip(got, token_table_chase_plain(ok.cpu(), NBP, NBP)):
        assert torch.equal(g.cpu(), w)


def x1_hazard_rows(seed: int, S: int, T_max: int, W: int):
    """Seeded inputs of kernel X1 (seg_c, s_c, w_c, n_tr: numpy int32) for
    S shards of T_max tokens (T_max >= 200), aimed at the chunks of 32
    tokens its kernel resolves: shard k is of kind k % 8: 0 every deficit
    nonzero (w > W), segment changes inside a chunk (token 7) and at a
    chunk's first token (32, 96, 128), n_tr = T_max; 1 n_tr = 0; 2, 3, 4
    n_tr = 31, 32, 33, a deficit at about one token in three and a change
    at token 31; 5 rare deficits and changes at random, n_tr random; 6
    n_tr = T_max, a change at each chunk's first token and a deficit at its
    last; 7 as 2-4 with n_tr = 127, 128, 129 in turns.  A copy of the
    generator in chip_smoke.py."""
    rng = np.random.default_rng(seed)
    t = np.arange(T_max)
    seg = np.zeros((S, T_max), np.int64)
    s_c = rng.integers(0, 1 << 20, (S, T_max))
    w_c = rng.integers(0, 9, (S, T_max))
    n_tr = np.zeros(S, np.int64)
    for k in range(S):
        kind = k % 8
        if kind == 0:
            n_tr[k] = T_max
            w_c[k] = W + 1 + rng.integers(0, 40, T_max)
            seg[k] = ((t >= 7).astype(int) + (t >= 32) + (t >= 96)
                      + (t >= 128))
        elif kind in (2, 3, 4, 7):
            n_tr[k] = 29 + kind if kind < 7 else 127 + k // 8 % 3
            w_c[k] = np.where(rng.random(T_max) < 0.35,
                              rng.integers(W // 2, 2 * W, T_max), w_c[k])
            seg[k] = t >= 31
        elif kind == 5:
            n_tr[k] = rng.integers(0, T_max + 1)
            w_c[k] = rng.integers(0, 300, T_max)
            seg[k] = np.cumsum(rng.random(T_max) < 0.01)
        elif kind == 6:
            n_tr[k] = T_max
            seg[k] = t // 32
            w_c[k] = np.where(t % 32 == 31, W + 3, w_c[k])
    return tuple(x.astype(np.int32) for x in (seg, s_c, w_c, n_tr))


@pytest.mark.parametrize("rows", ["random", "hazards S=1", "hazards S=7",
                                  "hazards S=203"])
def test_x1_kernel_equals_plain(cuda, rows):
    W = 1024
    if rows == "random":
        rng = np.random.default_rng(7)
        S, T_max = 40, 3000
        seg = np.cumsum(rng.random((S, T_max)) < 0.01,
                        axis=1).astype(np.int32)
        s_c = rng.integers(0, 1 << 20, (S, T_max)).astype(np.int32)
        w_c = rng.integers(0, 300, (S, T_max)).astype(np.int32)
        n_tr = rng.integers(0, T_max, S).astype(np.int32)
        arrays = (seg, s_c, w_c, n_tr)
    else:
        arrays = x1_hazard_rows(3, int(rows.split("=")[1]), 2100, W)
    args = [torch.from_numpy(x) for x in arrays]
    want = dw.trunc_deficits_plain(*args, W)
    before = dw.trunc_deficits.launches
    got = dw.trunc_deficits(*(a.to(cuda) for a in args), W)
    assert dw.trunc_deficits.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) > 0


@pytest.mark.parametrize("window", [8, 10, 15])
def test_x2_kernel_equals_plain(cuda, window):
    data = _text(30000, window)
    data = data[:12000] + b"\x00" * 2000 + data[12000:]
    blob = compress_sharded(data, window=window, shard_size=16384,
                            engine="device-commit")
    pieces = [p[1:] for p in _parse_frame(blob)[2]]
    bad = bytearray(pieces[0])
    bad[len(bad) // 2] ^= 0x5A
    pieces.append(bytes(bad))
    Lp = max(len(p) for p in pieces)
    pl = np.zeros((len(pieces), Lp), np.uint8)
    for i, p in enumerate(pieces):
        pl[i, : len(p)] = np.frombuffer(p, np.uint8)
    pl = torch.from_numpy(pl)
    nb = torch.tensor([len(p) for p in pieces], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    for max_out in (16384, 5000):
        kw = dict(window=window, literal=8, extended=True, more=False,
                  max_out=max_out)
        want = dser.serial_decode_plain(pl, nb, d, d, **kw)
        got = dser.serial_decode(pl.to(cuda), nb.to(cuda), d.to(cuda),
                                 d.to(cuda), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert want[0][0, :5000].numpy().tobytes() == data[:5000]


X2_HAZARD_KINDS = (
    "hazards", "more, double FLUSH", "out of bounds mid-stream",
    "trailing incomplete token", "max_out inside a match",
    "max_out inside an RLE of more than 8",
    "max_out at a multiple of 16 inside a match",
    "max_out at a multiple of 16 inside an RLE of more than 8")


def x2_hazard_streams(window: int, kind: str, n: int = 3):
    """Seeded hazard streams (:func:`hazard_stream`) for kernel X2, the
    token-serial decoder, and the max_out to decode them to: (streams,
    decoded lengths, more, max_out).  The "max_out" kinds cut the output
    inside a match or an extended match of 3+ bytes, or inside an RLE of
    more than 8 bytes, of the first stream's second half (the token that
    crosses max_out writes all its ring bytes but only its output bytes
    below max_out); at a multiple of 16 the kernel stores its rows in
    16-byte units.  chip_smoke.py holds a copy."""
    more = kind.startswith("more")
    spans = []
    streams, lens = zip(*(hazard_stream(
        window * 10 + i, window, more=more, n_tokens=1500 + 500 * i,
        oob_at=900 + 50 * i if kind.startswith("out of") else -1,
        spans=spans if i == 0 else None) for i in range(n)))
    max_out = 1 << max(max(lens), 1024).bit_length()
    if kind.startswith("max_out"):
        rle = "RLE" in kind
        at16 = "multiple of 16" in kind

        def cut(o, cnt):  # an output length inside the token
            return (o // 16 + 1) * 16 if at16 else o + cnt // 2

        _k, o, cnt = next(
            x for x in spans if x[1] >= min(lens) // 2 and (
                x[0] == "rle" and x[2] > 8 if rle
                else x[0] != "rle" and x[2] >= 3)
            and cut(x[1], x[2]) < x[1] + x[2])
        max_out = cut(o, cnt)
    if kind == "trailing incomplete token":
        streams = [x[:-2] for x in streams]
    return list(streams), list(lens), more, max_out


def _x2_pair(dev, streams, window, more, max_out):
    """X2 on the card against its plain version on the header-less payloads
    of ``streams``; returns the kernel's (out, lens, errs) on the host."""
    skip = 2 if more else 1
    pieces = [x[skip:] for x in streams]
    pl = np.zeros((len(pieces), max(len(p) for p in pieces)), np.uint8)
    for i, p in enumerate(pieces):
        pl[i, : len(p)] = np.frombuffer(p, np.uint8)
    pl = torch.from_numpy(pl)
    nb = torch.tensor([len(p) for p in pieces], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    kw = dict(window=window, literal=8, extended=True, more=more,
              max_out=max_out)
    want = dser.serial_decode_plain(pl, nb, d, d, **kw)
    before = dser.serial_decode.launches
    got = dser.serial_decode(pl.to(dev), nb.to(dev), d.to(dev), d.to(dev),
                             **kw)
    assert dser.serial_decode.launches == before + 1
    got = [g.cpu() for g in got]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("kind", X2_HAZARD_KINDS)
@pytest.mark.parametrize("window", [8, 10, 15])
def test_x2_kernel_equals_plain_on_hazard_streams(cuda, window, kind):
    streams, lens, more, max_out = x2_hazard_streams(window, kind)
    _out, got_lens, errs = _x2_pair(cuda, streams, window, more, max_out)
    oob = kind.startswith("out of")
    assert errs.tolist() == [dser.ERR_OOB if oob else dser.ERR_OK] * 3
    if kind != "trailing incomplete token":
        assert got_lens.tolist() == [min(n, max_out) for n in lens]
    if kind.startswith("max_out"):
        assert got_lens.tolist()[0] == max_out


@pytest.mark.parametrize("mode", ["chase", "xla", "serial"])
def test_decode_modes_round_trip_and_match_plain(cuda, mode):
    data = _text(40000, 5)
    blob = compress_sharded(data, shard_size=16384, engine="device-commit")
    if mode == "serial":
        kw = dict(algorithm="serial")
        counter = dser.serial_decode
    else:
        kw = {}
        counter = token_table_chase if mode == "chase" else \
            dw.trunc_deficits
    before = (counter.launches, dc.commit_decode.launches)
    prev = os.environ.get("TAMP_TPU_DECODE")
    os.environ["TAMP_TPU_DECODE"] = mode
    try:
        got = decompress_sharded_device(blob, **kw)
        plain = decompress_sharded_device(blob, device="cpu", **kw)
    finally:
        if prev is None:
            del os.environ["TAMP_TPU_DECODE"]
        else:
            os.environ["TAMP_TPU_DECODE"] = prev
    assert bytes(got) == bytes(plain) == data
    assert counter.launches > before[0]
    assert dc.commit_decode.launches == before[1]


def _greedy_planes(cuda, window, literal, lazy, seed):
    """B7's inputs on the card from kernel B5's cap-16 tables of two
    text shards (one short, one with a long run)."""
    lmask = (1 << literal) - 1
    S, NP = 2, 8192
    dh = np.zeros((S, NP), np.uint8)
    a = np.frombuffer(bytes(b & lmask for b in _text(8000, seed)), np.uint8)
    dh[0, :8000] = a[:8000]
    dh[1, :5000] = a[2000:7000]
    dh[1, 1000:1400] = 3
    npos = torch.tensor([8000, 5000], dtype=torch.int32, device=cuda)
    d = torch.from_numpy(dictionary_array(1 << window, literal)).to(cuda)
    dh = torch.from_numpy(dh).to(cuda)
    tabs = v1_tables(dh, npos, d, window_bits=window, cap=16, probe=lazy)
    pk = pack_predict_plane(dh, npos, tabs[0], tabs[1], dlast=int(d[-1]))
    pp = ((tabs[3] & 0x7FFF) | ((tabs[2] & 15) << 15)) if lazy else None
    return pk, pp, npos, tabs


@pytest.mark.parametrize("planes", ["text", "hazards"])
@pytest.mark.parametrize("window,literal,lazy", [
    (10, 8, False), (10, 8, True), (15, 8, False), (14, 6, True)])
def test_b7_kernel_equals_plain(cuda, window, literal, lazy, planes):
    if planes == "text":
        pk, pp, npos, _tabs = _greedy_planes(cuda, window, literal, lazy,
                                             window)
    else:  # tiles of the kernel's 4096 positions, and a rest
        pk, pp, npos = (torch.from_numpy(x).to(cuda)
                        for x in hazard_predict_planes(
                            window + lazy, 5, 3 * 4096 + 512, window,
                            literal))
    kw = dict(NP=pk.shape[1], window=window, literal=literal, lazy=lazy)
    before = greedy_predict_batch.launches
    bm, ent, st = greedy_predict_batch(pk, pp, npos, **kw)
    assert greedy_predict_batch.launches == before + 1
    pbm, pent, pst = greedy_predict_plain(pk.cpu(), None if pp is None
                                          else pp.cpu(), npos.cpu(), **kw)
    assert torch.equal(bm.cpu(), pbm)
    assert torch.equal(st.cpu(), pst)
    ne = pst[:, 0].tolist()
    for s, n in enumerate(ne):
        assert torch.equal(ent[s, :n].cpu(), pent[s, :n])
    if planes == "text":
        assert min(ne) > 0
    else:  # a row without entries, and one with npos < 16
        assert ne[1] == 0 and ne[4] == 0 and int(pst[4, 1]) == 0
        assert min(ne[0], ne[2], ne[3]) > 0


@pytest.mark.parametrize("lazy", [False, True])
def test_greedy_commit_ignores_holes_in_card_tables(cuda, lazy):
    _pk, _pp, npos, tabs = _greedy_planes(cuda, 10, 8, lazy, 3)
    n = int(npos[0])
    data = _text(8000, 3)[:n]
    tabs = [t[0, :n].cpu().numpy() for t in tabs]
    tabs = [t.astype(np.uint8 if k % 2 == 0 else np.int32)
            for k, t in enumerate(tabs)]
    want = greedy_compress(data, lazy_matching=lazy)
    assert greedy_compress(data, lazy_matching=lazy, tables=tabs) == want
    rng = np.random.default_rng(4)
    for frac in (0.3, 0.9, 1.0):
        hole = rng.random(n) < frac
        holed = [t.copy() for t in tabs]
        for k in range(0, len(holed), 2):
            holed[k][hole] = SPARSE_NONE
        assert greedy_compress(data, lazy_matching=lazy,
                               tables=holed) == want


@pytest.mark.parametrize("pull", ["sparse", "dense"])
@pytest.mark.parametrize("lazy", [False, True])
def test_greedy_entry_point_tiny_shards(cuda, pull, lazy):
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    before = greedy_predict_batch.launches
    for raw, size in ((b"", 1024), (tiny, 7), (tiny, 16), (tiny, 17),
                      (_text(20000, 8), 4096)):
        shards = [raw[i : i + size]
                  for i in range(0, len(raw), size)] or [b""]
        got = encode_ext_device_greedy(shards, lazy_matching=lazy, pull=pull)
        assert got == [greedy_compress(s, lazy_matching=lazy)
                       for s in shards]
        blob = _pack_frame(got, len(raw), size)
        assert bytes(decompress_sharded_device(blob)) == raw
    assert (greedy_predict_batch.launches > before) == (pull == "sparse")
    blob = compress_sharded(tiny, shard_size=16, engine="device-greedy",
                            lazy_matching=lazy)
    assert blob == compress_sharded(tiny, shard_size=16,
                                    engine="device-greedy",
                                    lazy_matching=lazy, device="cpu")


def hazard_opt_shards(seed: int, window: int, literal: int):
    """Seeded shards (a list of bytes) aimed at the optimal DPs' hazards
    (kernels X3 and X4): text of 1, 15, 16, 17, 1023, 1024, 1025, 1024 +
    134 and 2048 + 133 bytes (sizes straddling the blocks and the lookback
    K, npos < K), all-equal bytes, a long periodic stretch (matches at the
    cap; in the extended format ring-end room caps), byte runs whose
    forced-RLE regions split into chunks of 241 and 240, and below literal
    8 a byte wider than the literal amid text."""
    rng = np.random.default_rng(seed)
    lmask = (1 << literal) - 1
    words = [bytes(int(x) & lmask for x in rng.integers(97, 123, int(k)))
             for k in rng.integers(2, 9, 48)]
    sep = bytes([32 & lmask])

    def text(n):
        return sep.join(words[int(i)]
                        for i in rng.integers(0, 48, n // 2 + 2))[:n]

    shards = [text(n) for n in (1, 15, 16, 17, 1023, 1024, 1025, 1024 + 134,
                                2048 + 133)]
    shards.append(bytes([int(rng.integers(0, lmask + 1))]) * 1500)
    period = bytes(int(x) & lmask for x in rng.integers(0, 256, 23))
    shards.append((period * 100)[: 2000 + int(rng.integers(0, 100))])
    # run r of value (37 r + 5) & lmask: regions of 242 (chunk 240 + 2), 483
    # (241 + 240 + 2), 241, 12, 11 (no region) and 243 (241 + 2) bytes
    shards.append(b"".join(bytes([(37 * r + 5) & lmask]) * c for r, c in
                           enumerate((243, 484, 242, 13, 12, 244, 1, 2000)))
                  + text(300))
    if literal < 8:
        bad = bytearray(text(900))
        bad[450] = 0xFF
        shards.append(bytes(bad))
    return shards


def v1_opt_inputs(shards, window: int, literal: int, NP: int = 0):
    """Kernel X3's inputs for shards (numpy): (flen, data, npos), flen the
    exact tables at cap min(16, minp + 13) of the v1 default window, NP
    the v1 encode's padding (a power of two >= 512) unless given."""
    NP = NP or 1 << (max(max(len(x) for x in shards), 512) - 1).bit_length()
    S = len(shards)
    flen = np.zeros((S, NP), np.int32)
    data = np.zeros((S, NP), np.uint8)
    d8 = dictionary_array(1 << window, literal=8)
    for i, x in enumerate(shards):
        arr = np.frombuffer(x, np.uint8)
        flen[i, : len(x)] = host_v1_tables(
            arr, window=window, literal=literal, cap=v1_cap(window, literal),
            dictionary=d8)[0]
        data[i, : len(x)] = arr
    return flen, data, np.asarray([len(x) for x in shards], np.int32)


def x3_group_shards(window: int, literal: int, S: int, NP: int):
    """S seeded shards of at most NP bytes for X3's block groups: text
    (masked to the literal's bits) and the hazard shards from the last (cut
    to NP; at literal < 8 the last holds an unencodable byte), in turns."""
    haz = hazard_opt_shards(window, window, literal)
    lmask = (1 << literal) - 1
    return [haz[-1 - k // 2 % len(haz)][:NP] if k % 2 else
            (np.frombuffer(_text(NP, k), np.uint8)[: NP - 37 * (k % 5)]
             & lmask).tobytes() for k in range(S)]


def ext_opt_inputs(shards, window: int, literal: int, dictionary=None):
    """Kernel X4's inputs for shards (numpy), as the optimal extended
    encode makes them: (packed, data or None, npos, sideband_pos,
    sideband_cw)."""
    datas = [np.frombuffer(x, np.uint8) for x in shards]
    prep = optimal_prep(datas, window=window, literal=literal,
                        dictionary=dictionary)
    return optimal_batch(datas, prep, literal=literal)


def _on(dev, arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


_OPT_CASES = [(8, 8), (10, 8), (11, 6), (12, 8)]


# X3's blocks and groups: S shards of n_b = NP / B_V1 blocks each: one
# block, fewer than a group, a group and one block, not a multiple of a
# group
X3_GROUP_CASES = [(1, 1), (1, 33), (203, 5), (13, 40)]


@pytest.mark.parametrize(
    "window,literal,rows",
    [(w, l, r) for w, l in _OPT_CASES for r in ("hazards", "text")]
    + [(w, l, f"S={S} n_b={n_b}") for w, l in ((10, 8), (11, 6))
       for S, n_b in X3_GROUP_CASES])
def test_x3_kernel_equals_plain(cuda, window, literal, rows):
    if rows == "hazards":
        shards, NP = hazard_opt_shards(window, window, literal), 0
    elif rows == "text":
        shards, NP = [_text(65536, k)[:65536 - 7 * k] for k in range(4)], 0
    else:
        S, n_b = (int(x.split("=")[1]) for x in rows.split())
        NP = n_b * B_V1
        shards = x3_group_shards(window, literal, S, NP)
    args = v1_opt_inputs(shards, window, literal, NP)
    kw = dict(window=window, literal=literal)
    want = opt_v1_choice_plain(*_on("cpu", args), **kw)
    before = opt_v1_choice.launches
    got = opt_v1_choice(*_on(cuda, args), **kw)
    assert opt_v1_choice.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if NP:  # l6: the unencodable byte's shard is bad
        assert bool(want[2].any()) == (literal < 8 and len(shards) > 1)


@pytest.mark.parametrize("rows", ["hazards", "text"])
@pytest.mark.parametrize("window,literal", _OPT_CASES)
def test_x4_kernel_equals_plain(cuda, window, literal, rows):
    shards = (hazard_opt_shards(window, window, literal) if rows == "hazards"
              else [_text(65536, k)[:65536 - 7 * k] for k in range(4)])
    args = ext_opt_inputs(shards, window, literal)
    kw = dict(window=window, literal=literal)
    want = opt_ext_choice_plain(*_on(cuda, args), **kw)  # plain, on the card
    before = opt_ext_choice.launches
    got = opt_ext_choice(*_on(cuda, args), **kw)
    assert opt_ext_choice.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("B", [1024, 2048])
@pytest.mark.parametrize("window,literal", [(10, 8), (11, 6)])
def test_x4_kernel_equals_plain_at_block_size(cuda, monkeypatch, window,
                                              literal, B):
    from tamp_tpu_torch.ops import opt_parse_ext

    monkeypatch.setattr(opt_parse_ext, "B_EXT", B)
    shards = ([_text(65536, k)[:65536 - 7 * k] for k in range(3)]
              + hazard_opt_shards(window, window, literal)[-3:])
    args = ext_opt_inputs(shards, window, literal)
    kw = dict(window=window, literal=literal)
    want = opt_ext_choice_plain(*_on(cuda, args), **kw)
    got = opt_ext_choice(*_on(cuda, args), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("x", ["X3", "X4"])
def test_optimal_kernels_past_inf_equal_plain(cuda, x):
    """X3 and X4 on one 16 MiB row of chip_smoke.py's corpus, whose payload
    (~86 M bits) passes INF: the kernels' combine rebases its boundary
    vectors as the plain versions' does (on the card), so choice, bad and
    cost0 (saturated at INF) agree."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    shards = [chip_smoke.corpus(1 << 24)]
    kw = dict(window=10, literal=8)
    if x == "X3":
        args = _on(cuda, v1_opt_inputs(shards, **kw))
        want = opt_v1_choice_plain(*args, **kw)
        got = opt_v1_choice(*args, **kw)
    else:
        args = _on(cuda, ext_opt_inputs(shards, **kw))
        want = opt_ext_choice_plain(*args, **kw)
        got = opt_ext_choice(*args, **kw)
    assert int(want[1][0]) == INF and not bool(want[2][0])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def test_x4_kernel_pads_a_shard_below_its_chunk(cuda):
    # NP = 1000: the wrapper pads the planes to 1024 free positions
    shards = [_text(900, k)[: 900 - 50 * k] for k in range(3)]
    pk, _data, npos, sp, sc = ext_opt_inputs(shards, 10, 8)
    args = (pk[:, :1000], None, npos, sp, sc)
    kw = dict(window=10, literal=8)
    want = opt_ext_choice_plain(*_on(cuda, args), **kw)
    got = opt_ext_choice(*_on(cuda, args), **kw)
    assert got[0].shape == (3, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("extended", [False, True])
def test_optimal_entry_points_round_trip_and_match_plain(cuda, extended):
    data = _text(40000, 3) + b"\x07" * 600 + _text(9000, 4)
    for size in (1 << 14, 1000):
        blob = compress_sharded(data, shard_size=size, extended=extended,
                                engine="device-optimal")
        assert blob == compress_sharded(data, shard_size=size,
                                        extended=extended,
                                        engine="device-optimal", device="cpu")
        assert bytes(decompress_sharded_device(blob)) == data


@pytest.mark.parametrize("extended", [True, False])
@pytest.mark.parametrize("lazy", [False, True])
def test_device_engine_equals_plain(cuda, extended, lazy):
    """engine="device": kernel B5 and the host table committer, the
    one-shot form and the container, on the card equal to device="cpu"
    (B5's plain version), and B5 launched once a batch."""
    from tamp_tpu_torch.engine.pipeline import encode_device

    kw = dict(extended=extended, lazy_matching=lazy)
    data = _text(30000, 12) + b"\x05" * 2000 + _text(3000, 13)
    before = v1_tables.launches
    got = encode_device(data, **kw)
    assert v1_tables.launches == before + 1
    assert got == encode_device(data, device="cpu", **kw)
    for window, literal in ((8, 6), (15, 8)):
        lmask = (1 << literal) - 1
        raw = bytes(b & lmask for b in data[: 6000 >> (window - 8) // 7])
        one = encode_device(raw, window=window, literal=literal, **kw)
        assert one == encode_device(raw, window=window, literal=literal,
                                    device="cpu", **kw)
    before = v1_tables.launches
    blob = compress_sharded(data, engine="device", shard_size=4096, **kw)
    assert v1_tables.launches == before + 1
    assert blob == compress_sharded(data, engine="device", shard_size=4096,
                                    device="cpu", **kw)
    assert bytes(decompress_sharded_device(blob)) == data


@pytest.mark.parametrize("S", [1, 7, 203])
def test_b5_kernel_at_the_file_path_batch_shapes(cuda, S):
    """The file path's batches: up to 2 * workers shards, a short last
    one; extended rows are model histories.  B5 at cap 16 with the probe
    against its plain version, and compress_file_sharded's container
    against compress_sharded's."""
    import io

    from tamp_tpu_torch.parallel.shard import compress_file_sharded

    rng = np.random.default_rng(S)
    lens = rng.integers(1, 1024, S).astype(np.int32)
    lens[-1] = 17
    data = torch.from_numpy(rng.integers(97, 101, (S, 1024)).astype(np.uint8))
    npos = torch.from_numpy(lens)
    d = torch.from_numpy(dictionary_array(1 << 10))
    kw = dict(window_bits=10, cap=16, probe=True)
    want = v1_tables_plain(data, npos, d, **kw)
    got = v1_tables(data.to(cuda), npos.to(cuda), d.to(cuda), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    raw = _text(S * 300 + 100, S)
    dst = io.BytesIO()
    compress_file_sharded(io.BytesIO(raw), dst, shard_size=300,
                          workers=max(1, S // 2), engine="device")
    assert dst.getvalue() == compress_sharded(raw, engine="device",
                                              shard_size=300)


@pytest.fixture
def mesh1(cuda):
    """A world of one process on the card, torn down after the test."""
    import torch.distributed as tdist

    from tamp_tpu_torch.parallel.shard import make_mesh

    mesh = make_mesh()
    yield mesh
    tdist.destroy_process_group()


def test_mesh_steps_launch_b5_b4_and_x1(cuda, mesh1, monkeypatch):
    """The mesh steps in a world of one process: the search step launches
    B5 once, its tables equal B5's plain version and its estimate the
    plain tables'; the decode step launches B4 once in mode commit and X1
    (not B4) in mode xla, gives the input back, and raises on a stream
    that reads past the window end."""
    from tamp_tpu_torch.parallel.shard import (
        estimate_bits, sharded_decode_step, sharded_search_step,
    )

    raw = _text(4 * 4096, 40)[: 4 * 4096]
    data = np.frombuffer(raw, np.uint8).reshape(4, 4096)
    v1_tables.launches = 0
    out = sharded_search_step(mesh1, data, 10, 8)
    assert v1_tables.launches == 1
    want = v1_tables_plain(
        torch.from_numpy(data.copy()).to(cuda),
        torch.full((4,), 4096, dtype=torch.int32, device=cuda),
        torch.from_numpy(dictionary_array(1 << 10)).to(cuda),
        window_bits=10, cap=16)
    assert torch.equal(out["len16"], want[0])
    assert torch.equal(out["idx16"], want[1])
    est = float(estimate_bits(want[0], 10, 8).sum())
    assert float(out["est_bits_total"]) == pytest.approx(est, rel=1e-5)

    _r, _s, pieces = _parse_frame(compress_sharded(raw, shard_size=4096,
                                                   engine="device-commit"))
    for mode, kernel in (("commit", dc.commit_decode),
                         ("xla", dw.trunc_deficits)):
        monkeypatch.setenv("TAMP_TPU_DECODE", mode)
        dc.commit_decode.launches = dw.trunc_deficits.launches = 0
        outs, lens, total = sharded_decode_step(mesh1, pieces, max_out=4096)
        assert kernel.launches >= 1
        assert dc.commit_decode.launches == (mode == "commit")
        assert int(total) == len(raw)
        assert b"".join(outs[i, : lens[i]].cpu().numpy().tobytes()
                        for i in range(4)) == raw
    oob = _Bits()
    oob.put(pieces[0][0], 8)  # the same header: w10, l8, extended
    oob.put(0x100 | 0x41, 9)
    oob.put(HUFFMAN_CODES[11], HUFFMAN_LENGTHS[11])  # 13 bytes at 1020
    oob.put(1020, 10)
    with pytest.raises(ValueError):
        sharded_decode_step(mesh1, pieces[:3] + [oob.bytes()], max_out=4096)


def test_entry_launches_b5_twice_equal_to_plain(cuda):
    """The port's ``entry()``: its six tables on the card equal B5's plain
    version there (cap 15 with the probe, cap 16), from two B5 launches."""
    from tamp_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    v1_tables.launches = 0
    got = fn(*args)
    assert v1_tables.launches == 2
    l15, i15, pl, pi = v1_tables_plain(*args, window_bits=10, cap=15,
                                       probe=True)
    l16, i16 = v1_tables_plain(*args, window_bits=10, cap=16)
    for g, w in zip(got, (l15, i15, l16, i16, pl, pi)):
        assert torch.equal(g, w[0, :256])


@pytest.mark.parametrize("workers", [None, 2])
def test_file_decode_launches_a_kernel_a_batch(cuda, monkeypatch, workers):
    """``decompress_file_sharded`` of 8 shards: one batch by default, two
    of 4 at ``workers=2``; B4 launches once a batch in mode commit, X2
    once a batch by the serial algorithm, B8 in mode chase; the input
    comes back."""
    import io

    from tamp_tpu_torch.parallel.shard import decompress_file_sharded

    raw = _text(8 * 4096, 41)[: 8 * 4096 - 100]
    blob = compress_sharded(raw, shard_size=4096, engine="device-commit")
    batches = 1 if workers is None and 2 * (os.cpu_count() or 4) >= 8 \
        else -(-8 // (2 * (workers or os.cpu_count() or 4)))
    for algorithm, mode, kernel in (
            ("wavefront", "commit", dc.commit_decode),
            ("wavefront", "chase", token_table_chase),
            ("serial", "commit", dser.serial_decode)):
        monkeypatch.setenv("TAMP_TPU_DECODE", mode)
        kernel.launches = 0
        out = io.BytesIO()
        n = decompress_file_sharded(io.BytesIO(blob), out, workers,
                                    algorithm=algorithm)
        assert out.getvalue() == raw and n == len(raw)
        assert kernel.launches == batches, (algorithm, mode)


def test_dryrun_multichip_on_one_card(cuda):
    """``dryrun_multichip(1)`` runs to its end in a world of one process,
    launching B5 (the search step and the encode legs) and B4 (the decode
    step), and destroys its world."""
    import torch.distributed as tdist

    from tamp_tpu_torch.entry import dryrun_multichip

    v1_tables.launches = dc.commit_decode.launches = 0
    dryrun_multichip(1)
    assert not tdist.is_initialized()
    assert v1_tables.launches >= 1 and dc.commit_decode.launches >= 1


# (route, compress options, the kernels (wrappers) its compress launches)
ONE_SHOTS = (
    ("extended", {}, ("v1_tables", "greedy_predict_batch")),
    ("extended lazy", {"lazy_matching": True},
     ("v1_tables", "greedy_predict_batch")),
    ("v1", {"extended": False}, ("v1_tables", "commit_fields")),
    ("v1 lazy", {"extended": False, "lazy_matching": True},
     ("v1_tables", "commit_v1_lazy")),
    ("optimal", {"parse": "optimal"}, ("opt_ext_choice",)),
    ("optimal v1", {"parse": "optimal", "extended": False},
     ("v1_tables", "opt_v1_choice", "commit_fields")),
)


def _wrappers():
    return {fn.__name__: fn for fn in (
        v1_tables, greedy_predict_batch, commit_fields, commit_v1_lazy,
        opt_v1_choice, opt_ext_choice, dser.serial_decode)}


@pytest.mark.parametrize("route", [r[0] for r in ONE_SHOTS])
def test_one_shots_launch_and_equal_plain(cuda, route):
    """``tamp_tpu_torch.compress`` of one 40 KB stream on the card equals
    the plain versions' stream (``device="cpu"``) and launches its route's
    kernels; ``decompress`` gives the input back through one X2 launch,
    and for the extended format a stream of ~92x expansion through three
    (max_out grown twice)."""
    import tamp_tpu_torch as tt

    _, kw, kernels = next(r for r in ONE_SHOTS if r[0] == route)
    raw = _text(8000, 43)[:40000]
    fns = _wrappers()
    for f in fns.values():
        f.launches = 0
    blob = tt.compress(raw, **kw)
    ran = {k: f.launches for k, f in fns.items()}
    assert all(ran[k] >= 1 for k in kernels), ran
    assert blob == tt.compress(raw, device="cpu", **kw)
    dser.serial_decode.launches = 0
    assert tt.decompress(blob) == raw
    assert dser.serial_decode.launches == 1
    if not kw.get("extended", True):
        return  # no RLE tokens: v1 streams expand at most ~7.5x
    runs = tt.compress(b"q" * 300_000, **kw)
    dser.serial_decode.launches = 0
    assert tt.decompress(runs) == b"q" * 300_000
    assert dser.serial_decode.launches == 3


def test_cli_and_dictbuild_on_the_card(cuda, tmp_path):
    """``main()`` on the card: compress and decompress (raw and
    ``--sharded`` file to file) equal the API's and the plain versions';
    ``build-dictionary --auto-trim`` launches B5 and B7 once a threshold
    and writes the plain versions' dictionary."""
    import tamp_tpu_torch as tt
    from tamp_tpu_torch.cli.main import main
    from tamp_tpu_torch.dictbuild import build_dictionary

    raw = _text(6000, 44)
    src, out, back = (tmp_path / n for n in ("in", "out", "back"))
    src.write_bytes(raw)
    assert main(["compress", str(src), "-o", str(out)]) == 0
    assert out.read_bytes() == tt.compress(raw)
    assert main(["decompress", str(out), "-o", str(back)]) == 0
    assert back.read_bytes() == raw
    assert main(["compress", str(src), "-o", str(out), "--sharded",
                 "--shard-size", "4096"]) == 0
    assert out.read_bytes() == compress_sharded(
        raw, shard_size=4096, engine="device-greedy", device="cpu")
    assert main(["decompress", str(out), "-o", str(back)]) == 0
    assert back.read_bytes() == raw
    samples = [raw[i : i + 300] for i in range(0, len(raw), 300)]
    v1_tables.launches = greedy_predict_batch.launches = 0
    d = build_dictionary(samples, window=8, auto_trim=True)
    assert v1_tables.launches == greedy_predict_batch.launches == 6
    assert d == build_dictionary(samples, window=8, auto_trim=True,
                                 device="cpu")


@pytest.mark.parametrize("route", [r[0] for r in ONE_SHOTS])
def test_stream_limit_one_shots(cuda, route):
    """One stream of exactly ``MAX_STREAM_BYTES`` bytes (chip_smoke.py's
    seeded corpus) through the route's compress and one X2 decode gives
    the input back; the extended stream equals the table-less host
    committer's (the reference greedy encoder), and the optimal DPs run
    32 times past the 4 MiB at which their costs would reach INF without
    the combine's rebase; one byte more raises ValueError.
    Prints the seconds and peak device memory of each call."""
    import sys
    import time
    from pathlib import Path

    import tamp_tpu_torch as tt
    from tamp_tpu_torch.engine.greedy import greedy_compress

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    _, kw, kernels = next(r for r in ONE_SHOTS if r[0] == route)
    n = tt.MAX_STREAM_BYTES
    data = chip_smoke.corpus(n)
    fns = _wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    blob = tt.compress(data, **kw)
    enc_s = time.perf_counter() - t
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(fns[k].launches >= 1 for k in kernels)
    dser.serial_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    back = tt.decompress(blob)
    dec_s = time.perf_counter() - t
    dec_peak = torch.cuda.max_memory_allocated() / 2**30
    assert back == data and dser.serial_decode.launches == 1
    if route == "extended":
        assert blob == greedy_compress(data)
    with pytest.raises(ValueError, match=f"limited to {n} bytes"):
        tt.compress(data + b"x", **kw)
    print(f"\n{route}: {n} bytes as one stream, ratio {len(blob) / n:.6f}; "
          f"compress {enc_s:.2f} s (peak {enc_peak:.2f} GiB), decompress "
          f"{dec_s:.2f} s (peak {dec_peak:.2f} GiB)")

"""Per-position field planning for the planned extended commit walk.

Port of ``tamp_tpu/ops/plan_ext.py`` in tensor ops (no kernel).  The
planned model history is exact, so every decision of the planned walk is
a pure function of the model position:

    arrival at model position p  ->  (bit field, bit count, advance)

computed elementwise from the match tables, the run structure of the
model stream and the ring position ``p mod W``.  The commit kernel B3
(ops/encode_commit.py) then just pushes fields and jumps.

Field widths (flag included in HUFFMAN_LENGTHS):
  literal               1 + literal                 <= 9
  fused literal pair    2 * (1 + literal)           <= 18
  basic match           len(sym) + window           <= 9 + 15
  RLE                   9 + (len(sec) - 1) + 4      <= 21
  extended match        7 + (len(sec) - 1) + 3 + window = 18 + window

For window >= SPLIT_WINDOW the extended field exceeds 31 bits and is split:
the <= 18-bit header+trail goes in A, the window-bit index in B's high bits
(flag bit 15, index bits 16..30); the commit pushes it second.

All planes are (S, MP) int32 on one device; arithmetic matches the JAX
package bit for bit (int32, shifts by out-of-range amounts give 0 in both).
"""

from __future__ import annotations

import torch

from ..constants import (
    EXTENDED_MATCH_SYMBOL,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    RLE_SYMBOL,
    compute_min_pattern_size,
)

__all__ = ["plan_fields_ext", "derive_region_arrays", "MAX_PLAN_WINDOW",
           "SPLIT_WINDOW"]

MAX_PLAN_WINDOW = 15  # full lattice: >31-bit ext fields split (see above)
SPLIT_WINDOW = 14     # first window needing the two-push extended field

_I32 = torch.int32


def _rcummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along dim 1."""
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def _shift_left_fill(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, p + 1] at p, ``fill`` at the last column."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([x[:, 1:], pad], dim=1)


def _iota(ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(ref.shape[1], dtype=_I32,
                        device=ref.device).expand_as(ref)


def derive_region_arrays(rc: torch.Tensor, *, window: int):
    """(bound, rle_k) from the chunk-count stream ``rc`` (S, MP) int32.

    ``bound[m]`` = distance to the next chunk start strictly after m,
    clipped to 255; ``rle_k[m]`` = min(8, rc, W - m % W), the ring-end
    aware chunk keep at the chunk's model position."""
    MP = rc.shape[1]
    W = 1 << window
    big = MP + 256
    p = _iota(rc)
    nxt = torch.where(rc > 0, p, big)
    after = _shift_left_fill(_rcummin(nxt), big)
    bound = torch.clamp_max(after - p, 255)
    rk = torch.minimum(torch.clamp_max(rc, 8), W - (p & (W - 1)))
    return bound, rk


def _select(table, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], and 0 where idx is out of range (a compare-select)."""
    t = torch.tensor(table, dtype=_I32, device=idx.device)
    ok = (idx >= 0) & (idx < len(table))
    return torch.where(ok, t[idx.clamp(0, len(table) - 1).long()], 0)


def _sec_lookup(sec: torch.Tensor, trail: int):
    """(code, nbits) of the secondary huffman + trail form of ``sec``."""
    packed = [int(HUFFMAN_CODES[s]) | ((int(HUFFMAN_LENGTHS[s]) - 1 + trail)
                                       << 16) for s in range(15)]
    p = _select(packed, sec)
    return p & 0xFFFF, p >> 16


def _rle_field(count: torch.Tensor):
    """(value, nbits) of an RLE token for run length ``count`` (>= 2)."""
    v = count - 2
    scode, sbits = _sec_lookup(v >> 4, 4)
    head = torch.full_like(v, int(HUFFMAN_CODES[RLE_SYMBOL]))
    value = (((head << (sbits - 4)) | scode) << 4) | (v & 15)
    return value, int(HUFFMAN_LENGTHS[RLE_SYMBOL]) + sbits


def _ext_field(m: torch.Tensor, idx, minp: int, window: int):
    """(value, nbits) of an extended-match token of size ``m`` at ``idx``;
    ``idx=None`` gives the header+trail part only (the split form)."""
    v = m - minp - 12
    scode, sbits = _sec_lookup(v >> 3, 3)
    head = torch.full_like(v, int(HUFFMAN_CODES[EXTENDED_MATCH_SYMBOL]))
    hb = int(HUFFMAN_LENGTHS[EXTENDED_MATCH_SYMBOL])
    value = (((head << (sbits - 3)) | scode) << 3) | (v & 7)
    if idx is None:
        return value, hb + sbits
    return (value << window) | idx, hb + sbits + window


def _plan_stage1(dh: torch.Tensor, *, dlast: int):
    """Run structure: previous byte and run availability."""
    MP = dh.shape[1]
    p = _iota(dh)
    last = torch.cat([torch.full_like(dh[:, :1], dlast), dh[:, :-1]], dim=1)
    chg = (dh != last) | (dh > 255)
    nch_after = _shift_left_fill(_rcummin(torch.where(chg, p, MP)), MP)
    avail = torch.where(chg, 0, torch.clamp_max(nch_after, MP) - p)
    return last, torch.clamp_max(avail, 16)  # pend cap (steady state)


def _plan_stage2(dh, last, avail, len16, idx16, lenx, idxx, bound, rle_c,
                 rle_k, plen, pidx, *, window: int, literal: int):
    """Per-position decision and field values: (A, nb, adv, err, use_ev)
    before the literal-pair fuse; ``plen``/``pidx`` (or None) the probe
    planes of lazy matching."""
    minp = compute_min_pattern_size(window, literal)
    W = 1 << window
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    nbl = literal + 1
    room = W - (_iota(dh) & (W - 1))

    # first-search result (boundary-capped, table idx kept)
    size1 = torch.clamp_max(torch.minimum(len16, bound), 16)
    total = avail
    use_pattern = (total >= 2) & (total <= 6) & (size1 > total)
    do_rle = (total >= 2) & ~use_pattern

    # RLE action with the ring-end split
    split = total > room
    rle_cnt = torch.where(split, room, total)
    lit1 = split & (room == 1)  # 1-byte remainder crosses the ring end

    is_match = size1 >= minp

    # lazy deferral, pure-position: a basic match of size <= 8 becomes a
    # literal when the next position matches strictly longer (probe: target
    # p + 1, cap 15, ring at p) and the probe's source does not hold the
    # write head.  Only in the steady state (bound >= 16, where the cap-15
    # table equals the exact probe search), and nothing is cached: the walk
    # at p + 1 decides from its own tables.
    go_lazy = torch.zeros_like(is_match)
    if plen is not None:
        posring = _iota(dh) & (W - 1)
        overlap = (pidx <= posring) & (posring < pidx + plen)
        go_lazy = (is_match & (size1 <= 8) & (bound >= 16) & (plen > size1)
                   & ~overlap)
    ext_entry = is_match & (size1 > minp + 11)
    m = torch.minimum(lenx, bound)
    # avoid-divergence policy
    ext_fits = m <= room
    ext_short = ~ext_fits & (room >= minp + 12)
    ext_basic = ~ext_fits & (room < minp + 12)
    m_emit = torch.where(ext_fits, m, room)
    splitw = window >= SPLIT_WINDOW
    ev, en = _ext_field(torch.clamp_min(m_emit, minp + 12),
                        None if splitw else idxx, minp, window)
    # basic-match field (the plain match and the ext fallback)
    bm_len = torch.where(ext_entry, minp + 11, size1)
    bm_idx = torch.where(ext_entry, idxx, idx16)
    sym = torch.clamp(bm_len - minp, 0, 11)
    hsel = _select([(int(HUFFMAN_CODES[s]) << window)
                    | ((int(HUFFMAN_LENGTHS[s]) + window) << 25)
                    for s in range(12)], sym)
    bv = (hsel & 0x1FFFFFF) | bm_idx
    bn = (hsel >> 25) & 31

    # literal; the RLE split literal repeats `last` (== dh[p] inside a run)
    lv = lit_flag | (dh & 0xFF)
    lerr = dh >= lit_limit
    lsv = lit_flag | (last & 0xFF)
    lserr = last >= lit_limit

    # forced chunk starts and the dynamic RLE share one field lookup
    fr = rle_c >= 2
    rv, rn = _rle_field(torch.clamp_min(torch.where(fr, rle_c, rle_cnt), 2))

    # priority: forced-RLE chunk start > dynamic RLE > lazy literal >
    # pattern > literal
    zero = torch.zeros_like(dh)
    is_lit = ~do_rle & (~is_match | go_lazy)
    A = torch.where(is_lit, lv, zero)
    nb = torch.where(is_lit, nbl, zero)
    adv = torch.where(is_lit, 1, zero)
    err = is_lit & lerr

    use_bm = is_match & ~go_lazy & (~ext_entry | ext_basic) & ~do_rle
    use_ev = is_match & ext_entry & ~ext_basic & ~do_rle
    A = torch.where(use_bm, bv, A)
    nb = torch.where(use_bm, bn, nb)
    adv = torch.where(use_bm, bm_len, adv)
    A = torch.where(use_ev, ev, A)
    nb = torch.where(use_ev, en, nb)
    adv = torch.where(use_ev, torch.where(ext_short, room, m), adv)

    rle_tok = do_rle & ~lit1
    rle_lit = do_rle & lit1
    A = torch.where(rle_tok, rv, A)
    nb = torch.where(rle_tok, rn, nb)
    adv = torch.where(rle_tok, rle_cnt, adv)
    A = torch.where(rle_lit, lsv, A)
    nb = torch.where(rle_lit, nbl, nb)
    adv = torch.where(rle_lit, 1, adv)
    err = torch.where(do_rle, lit1 & lserr, err)

    # forced-RLE chunk starts override everything (walk inside regions)
    A = torch.where(fr, rv, A)
    nb = torch.where(fr, rn, nb)
    adv = torch.where(fr, rle_k, adv)
    err = err & ~fr
    return A, nb, adv, err, use_ev


def _plan_stage3(A, nb, adv, err, use_ev, idxx, *, window: int,
                 literal: int):
    """Fuse literal pairs and pack the B stream."""
    nbl = literal + 1
    is_lit_all = (nb == nbl) & (adv == 1)  # any single-literal action
    pair = is_lit_all & _shift_left_fill(is_lit_all, False)
    A2 = torch.roll(A, -1, dims=1)
    e2 = torch.roll(err, -1, dims=1)
    A = torch.where(pair, (A << nbl) | A2, A)
    nb = torch.where(pair, 2 * nbl, nb)
    adv = torch.where(pair, 2, adv)
    err = torch.where(pair, err | e2, err)

    B = nb | (adv << 6) | (err.to(_I32) << 14)
    if window >= SPLIT_WINDOW:
        # use_ev implies adv >= minp + 12 > 2: the fuse never touches it
        B = B | torch.where(use_ev, (1 << 15) | (idxx << 16), 0)
    return A, B


def plan_fields_ext(dh, len16, idx16, lenx, idxx, bound, rle_c, rle_k, *,
                    window: int, literal: int, dlast: int, plen=None,
                    pidx=None):
    """(A, B) per-position fields of the planned extended walk.

    All arrays (S, MP) int32 in model space: ``dh`` model bytes (padding
    value > 255); ``len16/idx16`` and ``lenx/idxx`` the two table families;
    ``bound``, ``rle_c``, ``rle_k`` the region planes (derive_region_arrays);
    ``dlast`` the dictionary's last byte; ``plen/pidx`` the probe family,
    given for lazy matching only.  A = field value; B = ``nb | adv << 6 |
    err << 14`` (plus the split index for window >= 14)."""
    last, avail = _plan_stage1(dh, dlast=dlast)
    A, nb, adv, err, use_ev = _plan_stage2(
        dh, last, avail, len16, idx16, lenx, idxx, bound, rle_c, rle_k,
        plen, pidx, window=window, literal=literal)
    return _plan_stage3(A, nb, adv, err, use_ev, idxx, window=window,
                        literal=literal)

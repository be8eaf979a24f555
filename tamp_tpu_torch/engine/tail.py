"""Host tail walk of the planned extended encode: the plain version.

The commit kernel stops at the first token start >= npos - 15; the tail
walk finishes the last < 16 model bytes of a shard on the host.  The main
path runs ``engine/greedy.host_ext_tail_bits``, the C++ copy of the JAX
package's tail owner (``tampn_ext_tail_bits`` resuming ``Committer::step``
in planned mode with ``avoid_divergence``; ``tpt_ext_tail_bits`` in
csrc/greedy_commit.cpp), a thread a shard.  This module is a Python copy
of the same walk, differential tested against both
(tests/test_torch_tail.py, tests/test_torch_host_prep.py); it has no lazy
rule, which the planned walk never applies with fewer than 16 model bytes
ahead.

The native walk re-searches the ring at each tail position; in planned mode
that search equals the model-space match tables at the same model position
(longest over the model target at full cap, lowest slot among the longest,
the boundary cap applied after with the index kept), so the walk reads the
few table rows it needs instead: the caller pulls the rows
``[base, base + len(rows))`` of the four tables from the device.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    EXTENDED_MATCH_SYMBOL,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    RLE_SYMBOL,
    compute_min_pattern_size,
)
from ..exceptions import ExcessBitsError
from .encode import bits_to_bytes
from .plan import RLE_MAX, RLE_MAX_WIN

__all__ = ["ext_tail_bits", "TAIL_ROWS"]

TAIL_ROWS = 16  # table rows per shard the walk may read (positions >= npos - 16)
_BIG = 1 << 62


def _rle_field(count: int):
    v = count - 2
    sec, trail = v >> 4, v & 15
    sb = HUFFMAN_LENGTHS[sec] - 1
    value = ((HUFFMAN_CODES[RLE_SYMBOL] << sb | HUFFMAN_CODES[sec]) << 4) | trail
    return value, HUFFMAN_LENGTHS[RLE_SYMBOL] + sb + 4


def _ext_field(m: int, idx: int, minp: int, window: int):
    v = m - minp - 12
    sec, trail = v >> 3, v & 7
    sb = HUFFMAN_LENGTHS[sec] - 1
    value = ((HUFFMAN_CODES[EXTENDED_MATCH_SYMBOL] << sb | HUFFMAN_CODES[sec])
             << 3) | trail
    return ((value << window) | idx,
            HUFFMAN_LENGTHS[EXTENDED_MATCH_SYMBOL] + sb + 3 + window)


def _match_field(size: int, idx: int, minp: int, window: int):
    return ((HUFFMAN_CODES[size - minp] << window) | idx,
            HUFFMAN_LENGTHS[size - minp] + window)


def _tail_fields(data, t: int, kwr: int, last: int, plans, khat, rows, base,
                 *, window: int, literal: int):
    """Token fields [(value, nbits), ...] of the planned walk from input
    position ``t`` (model position ``kwr``) to the end of ``data``.

    ``last``: the ring byte behind the write head; ``rows``: the four
    table rows (len16, idx16, lenx, idxx) at model positions
    ``base + i``."""
    l16, i16, lx, ix = rows
    N = len(data)
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    fields: list[tuple[int, int]] = []
    n_plan = len(plans)
    plan_i = 0
    rle_count = 0

    def row(k: int) -> int:
        if not 0 <= k - base < len(l16):
            raise AssertionError(f"tail walk reads table row {k} outside "
                                 f"[{base}, {base + len(l16)})")
        return k - base

    def lit(b: int) -> None:
        if b >= lit_limit:
            raise ExcessBitsError
        fields.append((lit_flag | int(b), literal + 1))

    def drain_rle() -> None:
        # Committer::emit_rle with the planned ring-end split (accumulated
        # counts keep their remainder accumulated)
        nonlocal rle_count, kwr
        while rle_count:
            count, rle_count = rle_count, 0
            if count == 1:
                lit(last)
                kwr += 1
                return
            r = W - (kwr % W)
            if min(count, RLE_MAX_WIN) > r:
                if r >= 2:
                    fields.append(_rle_field(r))
                    kwr += r
                    rle_count = count - r
                    continue
                lit(last)  # r == 1: one literal crosses the ring end
                kwr += 1
                rle_count = count - 1
                continue
            fields.append(_rle_field(count))
            kwr += min(count, RLE_MAX_WIN)
            return

    while t < N:
        while plan_i < n_plan and t >= plans[plan_i][1]:
            plan_i += 1
        B = int(plans[plan_i][0]) if plan_i < n_plan else _BIG
        # forced RLE at a region start, or resuming at a mid-region chunk
        # start (chunks are left-greedy: re-running the layout from any chunk
        # boundary yields the original chunks)
        if not rle_count and plan_i < n_plan and t >= B:
            e = int(plans[plan_i][1])
            plan_i += 1
            while t < e:
                remn = e - t
                c = remn if remn < RLE_MAX else RLE_MAX
                if remn - c == 1:
                    c -= 1
                fields.append(_rle_field(c))
                kwr += int(khat[t + c]) - int(khat[t])
                t += c
            continue
        rem = min(N - t, B - t)
        pend = min(rem, 16)
        avail = 0
        while (avail < pend and data[t + avail] == last
               and rle_count + avail < RLE_MAX):
            avail += 1
        total = rle_count + avail
        ended = avail < pend or total >= RLE_MAX or t + avail >= B
        if not ended and total > 0:
            rle_count = total
            t += avail
            continue
        if total >= 2:
            use_pattern = False
            if total == avail and total <= 6:
                k = row(int(khat[t]))
                use_pattern = min(int(l16[k]), rem, 16) > total
            if not use_pattern:
                if rle_count == 0:
                    r = W - (kwr % W)
                    if min(total, RLE_MAX_WIN) > r:  # ring-end split
                        if r >= 2:
                            t += r
                            rle_count = r
                            drain_rle()
                            continue
                        lit(int(data[t]))  # r == 1
                        kwr += 1
                        last = int(data[t])
                        t += 1
                        continue
                t += avail
                rle_count = total
                drain_rle()
                continue
            rle_count = 0
        elif total == 1:
            if rle_count == 1:
                rle_count = 0
                lit(last)
                kwr += 1
                continue
            rle_count = 0
        k = row(int(khat[t]))
        size = min(int(l16[k]), rem, 16)
        if size >= minp:
            if size > minp + 11:
                m = min(int(lx[k]), rem)
                mi = int(ix[k])
                r = W - (kwr % W)
                if m <= r:
                    fields.append(_ext_field(m, mi, minp, window))
                    adv = m
                elif r >= minp + 12:  # shorten to fill the ring exactly
                    fields.append(_ext_field(r, mi, minp, window))
                    adv = r
                else:  # too little room: a basic match (its write wraps)
                    adv = min(m, minp + 11)
                    fields.append(_match_field(adv, mi, minp, window))
            else:
                adv = size
                fields.append(_match_field(size, int(i16[k]), minp, window))
            kwr += adv
            t += adv
            last = int(data[t - 1])
            continue
        lit(int(data[t]))
        kwr += 1
        last = int(data[t])
        t += 1
    drain_rle()
    return fields


def ext_tail_bits(data, t_in: int, dh, khat, plans, rows, base: int, *,
                  window: int, literal: int, acc: int, an: int,
                  dict_last: int) -> bytes:
    """Tail bytes of a shard from input position ``t_in`` (a walk entry:
    the kernel's stop), with the kernel's <= 31-bit remainder ``(acc, an)``
    stitched in front and the final partial byte zero-padded.

    ``dh``/``khat``/``plans``: the shard's model history (engine/plan.py);
    ``rows``/``base``: the table rows at model positions ``base + i``;
    ``dict_last``: the dictionary's last byte (the ring byte behind model
    position 0)."""
    data = np.asarray(data, np.uint8)
    N = data.shape[0]
    fields = []
    if t_in < N:
        kwr = int(khat[t_in])
        last = int(dh[kwr - 1]) if kwr else int(dict_last)
        fields = _tail_fields(data, t_in, kwr, last, plans, khat, rows, base,
                              window=window, literal=literal)
    return bits_to_bytes(fields, acc, an)

"""The benchmark's plain reference of the planned extended encode.

Plain Python and NumPy, written from the planned walk's rules, for a whole
shard at once.  Its stream is the one ``compress_sharded(...,
extended=True, engine="device-commit")`` writes a shard, without lazy
matching and with the default dictionary.  Everything else is
:mod:`.tamp_plain`'s: the bit writer, the dictionary, the Huffman code and
the decoder that reads the stream back.

**The model history.**  Each maximal run ``[s, e)`` of 9 or more equal
bytes is planned: the byte at ``s`` is tokenized as usual, and ``[s + 1,
e)`` is covered by forced RLE chunks of at most 241 bytes that never leave
a single byte behind.  A chunk writes ``min(8, chunk, W - pos)`` of its
bytes into the window (an RLE write stops at the ring end), ``pos`` being
the ring's write head.  Every other byte is written once.  The bytes
written, in order, are the model stream ``dh``; ``khat[t]`` counts those
of input positions below ``t``.  The walk below never lets the window
depart from the model, so the window at model position ``p`` is the
dictionary followed by ``dh[:p]``, byte ``k`` in ring slot ``k mod W``.

**The walk** (model positions, while ``p < M - 15``, ``M = len(dh)``), one
token a visited position, by the first rule that holds:

1. a forced chunk starts at ``p``: an RLE token of the chunk's count; the
   walk moves on by the bytes the chunk writes;
2. the bytes from ``p`` that repeat the byte behind it (at most 16, cut to
   the next chunk start) are 2 or more, and unless they are 6 or fewer and
   the match at ``p`` is longer: an RLE token of them, split at the ring
   end (a room of 1 is a literal of the repeated byte);
3. the match at ``p`` (the longest prefix of ``dh[p:]`` of at most 16
   bytes in the window, the lowest slot among the longest, cut to the
   next chunk start) is shorter than the minimum pattern: a literal;
4. it is at most ``minp + 11`` long: a basic match;
5. else the extended match, searched once: the longest prefix of
   ``dh[p:]`` of at most ``minp + 131`` bytes (the lowest slot among the
   longest), cut to the next chunk start.  Where it would cross the ring
   end, it becomes an extended token of exactly the room left if that is
   at least ``minp + 12``, else a basic match of ``minp + 11`` bytes; the
   rest is tokenized again.

**The tail.**  From the input position of the walk's stop, the reference
greedy steps with a look-ahead below 16 finish the shard: runs of the last
byte accumulate up to the next plan start, a run of 6 or fewer gives way
to a longer match, an RLE that would cross the ring end is split there
(again and again, as the flush drain does with what is left), a forced
region met is covered chunk by chunk, and each match is capped at the
next plan start and at the input's end.

It imports nothing of the program it checks.
"""

from __future__ import annotations

import numpy as np

from .tamp_plain import (
    EXT_BITS, EXT_SYMBOL, LOOKAHEAD, RLE_BITS, RLE_MAX, RLE_SYMBOL,
    RLE_WINDOW_MAX, _Bits, dictionary, min_pattern_size,
)

__all__ = ["encode", "model", "MIN_PLANNED_RUN"]

MIN_PLANNED_RUN = 9
_BIG = 1 << 62


def _chunks(length: int):
    """The forced chunks' counts over a region of ``length`` bytes."""
    t = 0
    while t < length:
        c = min(RLE_MAX, length - t)
        if length - t - c == 1:
            c -= 1
        yield c
        t += c


def model(data: bytes, window: int):
    """(plans, khat, dh, chunks) of ``data``: the planned regions as
    ``(rle_start, end)``; ``khat`` (N + 1 entries); the model stream
    ``dh``; ``chunks`` maps a chunk's model start to its input count."""
    a = np.frombuffer(data, np.uint8)
    n = a.shape[0]
    W = 1 << window
    plans = []
    if n >= MIN_PLANNED_RUN:
        cut = np.flatnonzero(a[1:] != a[:-1]) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [n]])
        long = ends - starts >= MIN_PLANNED_RUN
        plans = [(int(s) + 1, int(e))
                 for s, e in zip(starts[long], ends[long])]
    keep = np.ones(n, bool)
    starts_in = []  # (input start, count)
    kept = prev = 0
    for s, e in plans:
        kept += s - prev
        t = s
        for c in _chunks(e - s):
            k = min(RLE_WINDOW_MAX, c, W - kept % W)
            keep[t + k : t + c] = False
            starts_in.append((t, c))
            kept += k
            t += c
        prev = e
    khat = np.zeros(n + 1, np.int64)
    np.cumsum(keep, out=khat[1:])
    chunks = {int(khat[t]): c for t, c in starts_in}
    return plans, khat, a[keep].tobytes(), chunks


class _Window:
    """The ring at a model position: the dictionary, then ``dh`` written
    byte ``k`` to slot ``k mod W``; searched as a linear buffer."""

    def __init__(self, dh: bytes, window: int, literal: int):
        self.W = 1 << window
        self.ring = dictionary(window, literal)
        self.dh = dh
        self.at = 0  # model bytes written
        self.minp = min_pattern_size(window, literal)

    def to(self, p: int) -> None:
        ring, dh, W = self.ring, self.dh, self.W
        k = self.at
        while k < p:
            s = k & (W - 1)
            n = min(p - k, W - s)
            ring[s : s + n] = dh[k : k + n]
            k += n
        self.at = k

    def longest(self, p: int, cap: int, start: int = 0):
        """(slot, size) of the longest prefix of ``dh[p:]`` of at most
        ``cap`` bytes in the window at ``p``, its lowest slot at or after
        ``start``; size 0 below the minimum pattern."""
        self.to(p)
        target = self.dh[p : p + cap]
        find = self.ring.find
        size = self.minp
        if len(target) < size:
            return 0, 0
        at = find(target[:size], start)
        if at < 0:
            return 0, 0
        while size < len(target):
            nxt = find(target[: size + 1], at)
            if nxt < 0:
                break
            at, size = nxt, size + 1
        return at, size


def _avail(dh: bytes, dlast: int) -> list:
    """At each model position, the bytes from it that repeat the byte
    behind it (the dictionary's last before position 0), at most 16."""
    d = np.frombuffer(dh, np.uint8)
    M = d.shape[0]
    if M == 0:
        return []
    behind = np.concatenate([[dlast], d[:-1]])
    change = d != behind
    pos = np.arange(M)
    nxt = np.where(change, pos, M)
    after = np.minimum.accumulate(nxt[::-1])[::-1]  # first change >= p
    after = np.concatenate([after[1:], [M]])  # first change > p
    return np.where(change, 0, np.minimum(after - pos, LOOKAHEAD)).tolist()


def _bound(chunks: dict, M: int) -> list:
    """At each model position, the distance to the next chunk start after
    it, at most 255."""
    cs = np.asarray(sorted(chunks) + [M + 256], np.int64)
    pos = np.arange(M)
    after = cs[np.searchsorted(cs, pos, side="right")]
    return np.minimum(after - pos, 255).tolist()


class _Tokens:
    """The token writer of one stream; ``events`` (a dict or None)
    counts the rules that fired by name."""

    def __init__(self, window: int, literal: int, events=None):
        self.bits = _Bits()
        self.events = events
        self.window, self.literal = window, literal
        self.minp = min_pattern_size(window, literal)
        self.bits.put(((window - 8) << 5) | ((literal - 5) << 3) | 2, 8)

    def note(self, name: str) -> None:
        if self.events is not None:
            self.events[name] = self.events.get(name, 0) + 1

    def lit(self, b: int) -> None:
        if b >> self.literal:
            raise ValueError("a byte wider than the literal")
        self.bits.put((1 << self.literal) | b, self.literal + 1)

    def rle(self, count: int) -> None:
        self.bits.huffman(RLE_SYMBOL)
        self.bits.extended(count - 2, RLE_BITS)

    def match(self, size: int, at: int) -> None:
        self.bits.huffman(size - self.minp)
        self.bits.put(at, self.window)

    def ext(self, size: int, at: int) -> None:
        self.bits.huffman(EXT_SYMBOL)
        self.bits.extended(size - self.minp - 12, EXT_BITS)
        self.bits.put(at, self.window)


def _walk(out: _Tokens, win: _Window, dh: bytes, chunks: dict, dlast: int,
          W: int) -> int:
    """The walk over the model positions ``p < M - 15``; returns where it
    stopped."""
    M = len(dh)
    minp = out.minp
    maxp = minp + 131
    avail = _avail(dh, dlast)
    bound = _bound(chunks, M)
    p = 0
    while p < M - 15:
        room = W - (p & (W - 1))
        c = chunks.get(p, 0)
        if c >= 2:
            out.rle(c)
            p += min(RLE_WINDOW_MAX, c, room)
            continue
        total = min(avail[p], bound[p])
        size = at = 0
        if total <= 6:
            at, size = win.longest(p, LOOKAHEAD)
            if size > bound[p]:
                out.note("match_cut_at_plan")
                size = bound[p]
        if total >= 2 and not (total <= 6 and size > total):
            if total <= room:
                out.rle(total)
                p += total
            elif room == 1:
                out.note("rle_split_room_1")
                out.lit(dh[p - 1] if p else dlast)
                p += 1
            else:
                out.note("rle_split")
                out.rle(room)
                p += room
            continue
        if size < minp:
            out.lit(dh[p])
            p += 1
        elif size <= minp + 11:
            out.match(size, at)
            p += size
        else:
            xat, m = win.longest(p, maxp, at)
            if m > bound[p]:
                out.note("match_cut_at_plan")
                m = bound[p]
            if m <= room:
                out.ext(m, xat)
                p += m
            elif room >= minp + 12:
                out.note("ext_to_ring_end")
                out.ext(room, xat)
                p += room
            else:
                out.note("ext_as_basic")
                out.match(minp + 11, xat)
                p += minp + 11
    return p


def _tail(out: _Tokens, win: _Window, data: bytes, t: int, plans, khat,
          dlast: int, W: int) -> None:
    """The greedy steps from input position ``t`` to the end of ``data``
    (fewer than 16 model bytes)."""
    N = len(data)
    minp = out.minp
    maxp = minp + 131
    dh = win.dh
    M = len(dh)
    k = int(khat[t])  # the ring's write head, in model bytes
    last = dh[k - 1] if k else dlast
    plan_i = 0
    rle_n = 0  # run bytes taken and not yet written

    def search(cap: int, start: int = 0):
        p = int(khat[t])
        return win.longest(p, min(cap, M - p), start)

    def drain() -> None:
        # a run taken: RLE tokens, split at the ring end until it fits
        nonlocal rle_n, k
        while rle_n:
            n, rle_n = rle_n, 0
            if n == 1:
                out.lit(last)
                k += 1
                return
            room = W - k % W
            if min(n, RLE_WINDOW_MAX) <= room:
                out.rle(n)
                k += min(n, RLE_WINDOW_MAX)
                return
            if room >= 2:
                out.note("rle_split")
                out.rle(room)
                k += room
                rle_n = n - room
            else:
                out.note("rle_split_room_1")
                out.lit(last)
                k += 1
                rle_n = n - 1

    while t < N:
        while plan_i < len(plans) and t >= plans[plan_i][1]:
            plan_i += 1
        B = plans[plan_i][0] if plan_i < len(plans) else _BIG
        if not rle_n and t >= B:  # a forced region, chunk by chunk
            e = plans[plan_i][1]
            plan_i += 1
            for c in _chunks(e - t):
                out.rle(c)
                k += int(khat[t + c] - khat[t])
                t += c
            continue
        rem = min(N - t, B - t)
        pend = min(rem, LOOKAHEAD)
        run = 0
        while run < pend and data[t + run] == last and rle_n + run < RLE_MAX:
            run += 1
        total = rle_n + run
        if total and run == pend and total < RLE_MAX and t + run < B:
            rle_n = total  # the run may go on
            t += run
            continue
        if total >= 2:
            longer = False
            if total == run and total <= 6:
                longer = min(search(LOOKAHEAD)[1], rem) > total
            if not longer:
                room = W - k % W
                if rle_n == 0 and min(total, RLE_WINDOW_MAX) > room:
                    if room >= 2:  # split at the ring end
                        out.note("rle_split")
                        t += room
                        rle_n = room
                        drain()
                        continue
                    out.note("rle_split_room_1")
                    out.lit(data[t])
                    k += 1
                    last = data[t]
                    t += 1
                    continue
                t += run
                rle_n = total
                drain()
                continue
            rle_n = 0
        elif total == 1:
            if rle_n == 1:
                rle_n = 0
                out.lit(last)
                k += 1
                continue
            rle_n = 0
        at, size = search(LOOKAHEAD)
        if size > rem:
            if rem == B - t:
                out.note("match_cut_at_plan")
            size = rem
        if size < minp:
            out.lit(data[t])
            k += 1
            last = data[t]
            t += 1
            continue
        if size <= minp + 11:
            out.match(size, at)
            n = size
        else:
            xat, m = search(maxp, at)
            if m > rem:
                if rem == B - t:
                    out.note("match_cut_at_plan")
                m = rem
            room = W - k % W
            if m <= room:
                out.ext(m, xat)
                n = m
            elif room >= minp + 12:
                out.note("ext_to_ring_end")
                out.ext(room, xat)
                n = room
            else:
                out.note("ext_as_basic")
                n = minp + 11
                out.match(n, xat)
        k += n
        t += n
        last = data[t - 1]
    drain()


def encode(data, *, window: int = 10, literal: int = 8,
           events: dict | None = None) -> bytes:
    """The planned extended stream of ``data``: no lazy matching, the
    default dictionary.  Raises ValueError for a byte wider than a
    literal.  ``events``, a dict, gains the count of each rule that fired
    beside the plain ones (``match_cut_at_plan``, ``rle_split``,
    ``rle_split_room_1``, ``ext_to_ring_end``, ``ext_as_basic``)."""
    data = bytes(data)
    W = 1 << window
    plans, khat, dh, chunks = model(data, window)
    dlast = dictionary(window, literal)[-1]
    out = _Tokens(window, literal, events)
    win = _Window(dh, window, literal)
    stop = _walk(out, win, dh, chunks, dlast, W)
    if stop < len(dh):  # the input position of model position ``stop``
        t = int(np.searchsorted(khat, stop + 1)) - 1
        _tail(out, win, data, t, plans, khat, dlast, W)
    return out.bits.close()

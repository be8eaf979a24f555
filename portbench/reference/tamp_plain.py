"""The benchmark's plain reference of the Tamp format and the TTPU frame.

Plain Python and NumPy, written from the Tamp specification
(BrianPugh/tamp, docs/source/specification.rst) and its reference
encoder's greedy rules (tamp/compressor.py), for a whole input at once:

- :func:`encode`: the reference greedy encoder (a 16-byte look-ahead;
  the longest match of the window as a linear buffer, its first
  occurrence; in the extended format the RLE and extended-match tokens),
  the default dictionary, no lazy matching, no FLUSH token at the end;
- :func:`decode`: any stream of the default dictionary, v1 or extended;
- :func:`count_tokens`: the tokens and the matches of a stream, its parse
  alone, vectorised (the rooflines' work counts);
- :func:`parse_frame`: the TTPU container's frame (versions 1 and 2).

It imports nothing of the program it checks and takes nothing the program
made but the bytes it judges.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["encode", "decode", "count_tokens", "parse_frame", "dictionary",
           "min_pattern_size", "FrameError"]

# the static Huffman code of match sizes; the codes include the leading 0
# token flag and the lengths count it
HUFFMAN_CODES = (0x00, 0x03, 0x08, 0x0B, 0x14, 0x24, 0x26, 0x2B, 0x4B, 0x54,
                 0x94, 0x95, 0xAA, 0x27, 0xAB)
HUFFMAN_LENGTHS = (2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7, 9)
RLE_SYMBOL, EXT_SYMBOL, FLUSH_SYMBOL = 12, 13, 14
RLE_BITS, EXT_BITS = 4, 3  # trailing bits of the two extended values
RLE_MAX = (14 << RLE_BITS) + (1 << RLE_BITS) - 1 + 2  # 241
RLE_WINDOW_MAX = 8  # run bytes written into the window
LOOKAHEAD = 16
DICT_SEED = 3758097560
CHARS_8BIT = b" \x000ei>to<ans\nr/."
CHARS_COMMON = b" etaoinshrdlcumw"
MAGIC = b"TTPU"


class FrameError(ValueError):
    """A TTPU frame that does not parse."""


def min_pattern_size(window: int, literal: int) -> int:
    return 2 + (1 if window > 10 + ((literal - 5) << 1) else 0)


def dictionary(window: int, literal: int) -> bytearray:
    """The default initial window: XorShift32 draws, eight characters of
    the 16-character table a draw, low nibble first."""
    chars = CHARS_8BIT if literal > 6 else bytes(
        c & ((1 << literal) - 1) for c in CHARS_COMMON)
    size = 1 << window
    out = bytearray(size)
    s = DICT_SEED
    for i in range(0, size - 7, 8):
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        for j in range(8):
            out[i + j] = chars[(s >> (4 * j)) & 15]
    return out


class _Bits:
    """MSB-first bit writer."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def huffman(self, sym: int) -> None:
        self.put(HUFFMAN_CODES[sym], HUFFMAN_LENGTHS[sym])

    def extended(self, value: int, trailing: int) -> None:
        sym = value >> trailing
        self.put(HUFFMAN_CODES[sym], HUFFMAN_LENGTHS[sym] - 1)
        self.put(value, trailing)

    def close(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(self.out)


def encode(data, *, window: int = 10, literal: int = 8,
           extended: bool = True) -> bytes:
    """The reference greedy encoder's stream of ``data``."""
    data = bytes(data)
    n = len(data)
    W = 1 << window
    mps = min_pattern_size(window, literal)
    maxp = mps + 131 if extended else mps + 13
    win = dictionary(window, literal if extended else 8)
    bits = _Bits()
    bits.put(((window - 8) << 5) | ((literal - 5) << 3)
             | (2 if extended else 0), 8)
    pos = 0  # the next window slot written
    rle = ext_n = ext_at = 0
    find = win.find

    def longest(target: bytes, start: int = 0):
        """(index, size) of the longest prefix of ``target`` in the window,
        its first occurrence at or after ``start``; a size below ``mps``
        when there is none."""
        limit = min(len(target), maxp)
        size = mps
        if limit < size:
            return start, 0
        at = find(target[:size], start)
        if at < 0:
            return start, size - 1
        while size < limit:
            nxt = find(target[: size + 1], at)
            if nxt < 0:
                break
            at, size = nxt, size + 1
        return at, size

    def push(chunk) -> None:
        nonlocal pos
        for b in chunk:
            win[pos] = b
            pos += 1
            if pos == W:
                pos = 0

    def literal_token(b: int) -> None:
        if b >> literal:
            raise ValueError("a byte wider than the literal")
        bits.put((1 << literal) | b, literal + 1)
        push((b,))

    def emit_rle() -> None:
        nonlocal rle
        count, rle = rle, 0
        b = win[pos - 1]  # pos 0 reads win[-1], the ring's last slot
        if count == 1:
            literal_token(b)
            return
        bits.huffman(RLE_SYMBOL)
        bits.extended(count - 2, RLE_BITS)
        push(bytes((b,)) * min(count, RLE_WINDOW_MAX, W - pos))

    def emit_ext() -> None:
        nonlocal ext_n, ext_at, pos
        bits.huffman(EXT_SYMBOL)
        bits.extended(ext_n - mps - 12, EXT_BITS)
        bits.put(ext_at, window)
        k = min(ext_n, W - pos)  # no wrap: the copy stops at the ring end
        win[pos : pos + k] = win[ext_at : ext_at + k]
        pos = (pos + k) % W
        ext_n = ext_at = 0

    p = 0
    while p < n:
        ahead = data[p : p + LOOKAHEAD]
        if ext_n:  # grow the held extended match a byte at a time
            if ext_at + ext_n >= W:
                emit_ext()
                continue
            at, size = longest(bytes(win[ext_at : ext_at + ext_n])
                               + data[p : p + 1], ext_at)
            if size > ext_n:
                p += 1
                ext_n, ext_at = size, at
                if ext_n == maxp:
                    emit_ext()
            else:
                emit_ext()
            continue
        if extended:
            last = win[pos - 1]
            avail = 0
            for b in ahead:
                if b != last or rle + avail >= RLE_MAX:
                    break
                avail += 1
            total = rle + avail
            if total and not (avail < len(ahead) or total >= RLE_MAX):
                rle = total  # the run may go on: take it and look again
                p += avail
                continue
            if total >= 2:
                if not (total == avail and total <= 6
                        and longest(ahead)[1] > total):
                    p += avail
                    rle = total
                    emit_rle()
                    continue
                rle = 0
            elif total == 1:
                if rle == 1:
                    emit_rle()
                    continue
                rle = 0
        at, size = longest(ahead)
        if size >= mps:
            if extended and size > mps + 11:
                ext_at, ext_n = at, size  # hold it and keep growing
            else:
                bits.huffman(size - mps)
                bits.put(at, window)
                push(ahead[:size])
            p += size
        else:
            literal_token(ahead[0])
            p += 1
    if extended and rle:
        emit_rle()
    if extended and ext_n:
        emit_ext()
    return bits.close()


_DECODE = {}
for _s in range(15):
    _k = HUFFMAN_LENGTHS[_s] - 1
    _DECODE[(_k, HUFFMAN_CODES[_s] & ((1 << _k) - 1))] = _s


def decode(stream, *, rle_window: int = RLE_WINDOW_MAX) -> bytes:
    """The bytes of one Tamp stream of the default dictionary.  Raises
    ValueError for a stream this reference does not read (a custom
    dictionary, a dictionary reset, a bad code).  ``rle_window``, the run
    bytes written into the window, is the format's 8 but for the
    benchmark's control, which breaks it."""
    stream = bytes(stream)
    if not stream:
        raise ValueError("empty stream")
    head = stream[0]
    window, literal = (head >> 5) + 8, ((head >> 3) & 3) + 5
    if head & 4:
        raise ValueError("a custom-dictionary stream")
    if head & 1:
        raise ValueError("a dictionary-reset stream")
    extended = bool(head & 2)
    W = 1 << window
    mps = min_pattern_size(window, literal)
    win = dictionary(window, literal if extended else 8)
    pos = 0
    out = bytearray()
    src = stream[1:]
    total_bits = 8 * len(src)
    at = 0  # the bit offset read next

    def read(k: int) -> int:
        nonlocal at
        if at + k > total_bits:
            raise EOFError
        v = int.from_bytes(src[at >> 3 : ((at + k + 7) >> 3)], "big")
        v = (v >> (((at + k + 7) & ~7) - at - k)) & ((1 << k) - 1)
        at += k
        return v

    def symbol() -> int:
        code = 0
        for k in range(1, 9):
            code = (code << 1) | read(1)
            s = _DECODE.get((k, code))
            if s is not None:
                return s
        raise ValueError("a bad Huffman code")

    def push(chunk) -> None:
        nonlocal pos
        for b in chunk:
            win[pos] = b
            pos += 1
            if pos == W:
                pos = 0

    def window_get(i: int, size: int) -> bytes:
        if i + size <= W:
            return bytes(win[i : i + size])
        return bytes(win[(i + j) % W] for j in range(size))

    while True:
        start = at
        try:
            if read(1):
                b = read(literal)
                out.append(b)
                push((b,))
                continue
            s = symbol()
            if s == FLUSH_SYMBOL:
                at = (at + 7) & ~7
                continue
            if extended and s == RLE_SYMBOL:
                v = symbol()
                count = ((v << RLE_BITS) | read(RLE_BITS)) + 2
                chunk = bytes((win[pos - 1],)) * count
                out += chunk
                push(chunk[: min(count, rle_window, W - pos)])
                continue
            if extended and s == EXT_SYMBOL:
                v = symbol()
                size = ((v << EXT_BITS) | read(EXT_BITS)) + mps + 12
                chunk = window_get(read(window), size)
                out += chunk
                push(chunk[: min(size, W - pos)])
                continue
            chunk = window_get(read(window), s + mps)
            out += chunk
            push(chunk)
        except EOFError:
            if total_bits - start >= 8:
                raise ValueError("a stream cut inside a token") from None
            return bytes(out)


def _code_table(bits: int, flag: bool):
    """(symbol, code length) of every ``bits``-bit value read from a code's
    first bit (-1, 0 where no code begins it); with ``flag`` the codes
    carry their leading 0 token flag, without it (an extended token's
    second symbol) they do not."""
    sym = np.full(1 << bits, -1, np.int32)
    size = np.zeros(1 << bits, np.int32)
    for s, (c, n) in enumerate(zip(HUFFMAN_CODES, HUFFMAN_LENGTHS)):
        if not flag:
            n -= 1
            c &= (1 << n) - 1
        lo = c << (bits - n)
        sym[lo : lo + (1 << (bits - n))] = s
        size[lo : lo + (1 << (bits - n))] = n
    return sym, size


_FIRST = _code_table(9, True)
_SECOND = _code_table(8, False)


def count_tokens(stream) -> tuple[int, int]:
    """(tokens, matches) of one Tamp stream: every literal, match, RLE and
    extended-match token (FLUSH tokens are not counted), and of them the
    matches, short or extended.  The token that begins at each bit is sized
    at once with NumPy; then the walk from bit 0 visits each token once.
    Raises ValueError where :func:`decode` would."""
    stream = bytes(stream)
    if not stream:
        raise ValueError("empty stream")
    head = stream[0]
    window, literal = (head >> 5) + 8, ((head >> 3) & 3) + 5
    extended = bool(head & 2)
    nbits = 8 * (len(stream) - 1)
    if nbits == 0:
        return 0, 0
    src = np.frombuffer(stream[1:] + bytes(8), np.uint8).astype(np.int64)
    nb = nbits >> 3
    word = np.zeros(nb, np.int64)
    for k in range(5):  # the 40 bits from each byte
        word = (word << 8) | src[k : k + nb]
    # the 32 bits from each bit
    w = ((np.repeat(word, 8).reshape(nb, 8)
          >> np.arange(8, 0, -1, dtype=np.int64)) & 0xFFFFFFFF).ravel()
    del word
    lit = (w >> 31) == 1
    sym = _FIRST[0][w >> 23]
    n1 = _FIRST[1][w >> 23]
    n2 = _SECOND[1][((w << n1) & 0xFFFFFFFF) >> 24]
    del w
    rle = extended & (sym == RLE_SYMBOL)
    ext = extended & (sym == EXT_SYMBOL)
    flush = sym == FLUSH_SYMBOL
    p = np.arange(nbits, dtype=np.int32)
    size = np.where(lit, 1 + literal, n1 + window)
    size = np.where(rle, n1 + n2 + RLE_BITS, size)
    size = np.where(ext, n1 + n2 + EXT_BITS + window, size)
    size = np.where(flush, ((p + n1 + 7) & ~7) - p, size)
    bad = ~lit & ((sym < 0) | ((rle | ext) & (n2 == 0)))
    nxt = np.where(bad, -1, p + size)
    counted = (~flush | lit).astype(np.uint8).tobytes()
    match = (~lit & ~flush & ~rle & (sym >= 0)).astype(np.uint8).tobytes()
    nxt = nxt.tolist()
    at = tokens = matches = 0
    while at < nbits:
        n = nxt[at]
        if n < 0:
            raise ValueError("a bad Huffman code")
        if n > nbits:
            if nbits - at >= 8:
                raise ValueError("a stream cut inside a token")
            break
        tokens += counted[at]
        matches += match[at]
        at = n
    return tokens, matches


def parse_frame(blob):
    """(version, raw_size, shard_size or None, [stream bytes]) of a TTPU
    container; FrameError where the frame is not whole and exact."""
    blob = memoryview(blob)
    if len(blob) < 18 or bytes(blob[:4]) != MAGIC:
        raise FrameError("no TTPU magic")
    ver, _res, count, raw = struct.unpack_from("<BBIQ", blob, 4)
    at = 18
    shard_size = None
    if ver == 2:
        if len(blob) < 26:
            raise FrameError("a cut v2 head")
        (shard_size,) = struct.unpack_from("<Q", blob, 18)
        at = 26
    elif ver != 1:
        raise FrameError(f"version {ver}")
    if len(blob) < at + 4 * count:
        raise FrameError("a cut sizes table")
    sizes = np.frombuffer(blob, "<u4", count, at).astype(np.int64)
    at += 4 * count
    if at + int(sizes.sum()) != len(blob):
        raise FrameError("the sizes do not add up to the container")
    ends = at + np.cumsum(sizes)
    return ver, raw, shard_size, [bytes(blob[e - s : e])
                                  for s, e in zip(sizes, ends)]

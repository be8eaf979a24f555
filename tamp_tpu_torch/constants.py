"""Tamp bitstream format constants (the port's copy of ``tamp_tpu.constants``).

These values define the on-the-wire Tamp format and must match the published
specification exactly (reference: docs/source/specification.rst, and the
tables at tamp/compressor.py:25-33 / tamp/decompressor.py:22-38 of
BrianPugh/tamp).  These numbers are the contract both packages share.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Static Huffman table for match sizes.
#
# Symbol s in [0, 13] encodes a match of length (min_pattern_size + s) in the
# basic format.  Symbol 14 is the FLUSH marker.  In the extended format,
# symbol 12 is repurposed as the RLE token and symbol 13 as the extended-match
# token.  HUFFMAN_CODES[s] already includes the leading 0 "token" flag bit;
# HUFFMAN_LENGTHS[s] counts that flag bit too.
# ---------------------------------------------------------------------------
HUFFMAN_CODES = (
    0x00,  # 0  -> 0b0          (2 bits with flag: 00)
    0x03,  # 1  -> 0b11
    0x08,  # 2  -> 0b1000
    0x0B,  # 3  -> 0b1011
    0x14,  # 4  -> 0b10100
    0x24,  # 5  -> 0b100100
    0x26,  # 6  -> 0b100110
    0x2B,  # 7  -> 0b101011
    0x4B,  # 8  -> 0b1001011
    0x54,  # 9  -> 0b1010100
    0x94,  # 10 -> 0b10010100
    0x95,  # 11 -> 0b10010101
    0xAA,  # 12 -> 0b10101010  (RLE token in extended format)
    0x27,  # 13 -> 0b100111    (extended-match token in extended format)
    0xAB,  # 14 -> 0b10101011  (FLUSH)
)
HUFFMAN_LENGTHS = (2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7, 9)

#: Number of Huffman symbols (including FLUSH).
NUM_SYMBOLS = 15

#: Symbol indices with special meaning.
RLE_SYMBOL = 12
EXTENDED_MATCH_SYMBOL = 13
FLUSH_SYMBOL = 14

#: The FLUSH code as written on the wire: 9 bits, value 0x0AB (0b010101011).
FLUSH_CODE = 0xAB
FLUSH_BITS = 9

#: Trailing ("extra") bit counts for the secondary extended-Huffman encoding.
RLE_TRAILING_BITS = 4
EXTENDED_MATCH_TRAILING_BITS = 3

#: RLE runs encode counts in [2, 241]: (14 << 4) + 15 + 2.
RLE_MIN_COUNT = 2
RLE_MAX_COUNT = ((14 << RLE_TRAILING_BITS) + ((1 << RLE_TRAILING_BITS) - 1)
                 + RLE_MIN_COUNT)
#: At most this many bytes of an RLE run are written into the window.
RLE_MAX_WINDOW_WRITE = 8

#: Extended matches span [min_pattern + 12, min_pattern + 131].
EXTENDED_MATCH_EXTRA_MAX = (14 << EXTENDED_MATCH_TRAILING_BITS) + (
    (1 << EXTENDED_MATCH_TRAILING_BITS) - 1
)  # 119

#: XorShift32 seed used for default dictionary initialization
#: (reference: tamp/__init__.py:37, discovered by tools/find_seed.py).
DICTIONARY_SEED = 3758097560

#: Character tables used to fill the initial dictionary, keyed by literal width.
#: For literal <= 6 the common-English table is masked down to the bit width.
CHARS_8BIT = b" \x000ei>to<ans\nr/."
CHARS_COMMON = b" etaoinshrdlcumw"

#: Valid configuration ranges.
WINDOW_BITS_MIN = 8
WINDOW_BITS_MAX = 15
LITERAL_BITS_MIN = 5
LITERAL_BITS_MAX = 8

#: Size of the reference compressor's look-ahead buffer: the streaming
#: codec (compressor.py) emits tokens only with this many bytes pending.
INPUT_BUFFER_SIZE = 16


def _build_decode_table():
    """The 256-entry Huffman decode table: indexed by the next 8 bits of the
    stream (MSB-first, the literal flag excluded), each entry is ``(symbol,
    nbits)`` with ``nbits`` the Huffman bits only.  The code is complete,
    so every entry is valid (none stays ``(-1, 0)``)."""
    table = [(-1, 0)] * 256
    for sym in range(NUM_SYMBOLS):
        nbits = HUFFMAN_LENGTHS[sym] - 1  # strip the flag bit
        code = HUFFMAN_CODES[sym] & ((1 << nbits) - 1)  # strip the 0 flag
        pad = 8 - nbits  # every 8-bit word starting with the code
        base = code << pad
        for fill in range(1 << pad):
            table[base | fill] = (sym, nbits)
    return tuple(table)


#: 256-entry (symbol, huffman_bits) decode table, indexed by the next 8 bits.
HUFFMAN_DECODE_TABLE = _build_decode_table()


def compute_min_pattern_size(window: int, literal: int) -> int:
    """Minimum beneficial match length for a (window, literal) configuration.

    A match token costs ``2 + huffman + window`` bits; it must beat the
    equivalent run of ``(1 + literal)``-bit literals.  The reference derives
    the closed form ``2 + (window > 10 + 2*(literal-5))``
    (tamp/__init__.py:66-70).
    """
    if not (WINDOW_BITS_MIN <= window <= WINDOW_BITS_MAX):
        raise ValueError(f"window must be in [8, 15], got {window}")
    if not (LITERAL_BITS_MIN <= literal <= LITERAL_BITS_MAX):
        raise ValueError(f"literal must be in [5, 8], got {literal}")
    return 2 + (1 if window > 10 + ((literal - 5) << 1) else 0)


def max_pattern_size(window: int, literal: int, extended: bool) -> int:
    """Longest encodable match for a configuration."""
    mps = compute_min_pattern_size(window, literal)
    if extended:
        return mps + 11 + EXTENDED_MATCH_EXTRA_MAX + 1  # mps + 131
    return mps + 13

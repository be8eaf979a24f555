"""Default dictionary (initial window) generation.

The Tamp format seeds the ring buffer with pseudo-random draws from a small
character table using the XorShift32 generator (spec: docs/specification.md
"Dictionary Initialization").  The byte stream is a format invariant: both
ends must produce identical buffers, so this is a copy of the host
generator of the JAX package, kept here so the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np

from .constants import CHARS_8BIT, CHARS_COMMON, DICTIONARY_SEED

__all__ = ["dictionary_array", "initialize_dictionary", "character_table",
           "xorshift32_sequence"]


def character_table(literal: int = 8) -> bytes:
    """The 16-character seed table for a literal bit-width."""
    if not (5 <= literal <= 8):
        raise ValueError("literal must be between 5 and 8")
    if literal <= 6:
        mask = (1 << literal) - 1
        return bytes(c & mask for c in CHARS_COMMON)
    return CHARS_8BIT


def xorshift32_sequence(n: int, seed: int = DICTIONARY_SEED) -> np.ndarray:
    """First ``n`` values of the XorShift32 stream as uint32."""
    out = np.empty(n, dtype=np.uint64)
    s = seed & 0xFFFFFFFF
    for i in range(n):
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        out[i] = s
    return out.astype(np.uint32)


def dictionary_array(size: int, literal: int = 8,
                     seed: int | None = None) -> np.ndarray:
    """The initialized dictionary as a uint8 NumPy array.

    ``size`` is typically ``1 << window_bits``; only ``(size >> 3) << 3``
    bytes are generated (8 bytes per PRNG draw, any remainder stays zero).
    """
    if seed is None:
        seed = DICTIONARY_SEED
    out = np.zeros(size, dtype=np.uint8)
    if seed == 0:
        return out
    chars = np.frombuffer(character_table(literal), dtype=np.uint8)
    n_words = size >> 3
    if n_words:
        words = xorshift32_sequence(n_words, seed)
        # Each word yields 8 characters, low nibble first.
        shifts = np.arange(8, dtype=np.uint32) * 4
        nibbles = (words[:, None] >> shifts[None, :]) & np.uint32(0x0F)
        out[: n_words * 8] = chars[nibbles.reshape(-1)]
    return out


def initialize_dictionary(source, seed=None, literal: int = 8) -> bytearray:
    """Initialize a dictionary buffer, API-compatible with ``tamp``.

    ``source`` may be an integer size (a fresh buffer is returned) or a
    ``bytearray`` to fill in place.  ``seed=0`` leaves/returns the buffer
    contents unchanged (reference behavior: tamp/__init__.py:38-39).
    """
    if not (5 <= literal <= 8):
        raise ValueError("literal must be between 5 and 8")
    if seed is None:
        seed = DICTIONARY_SEED
    elif seed == 0:
        return bytearray(source)
    if isinstance(source, (int, np.integer)):
        size = int(source)
        buf = bytearray(size)
    else:
        buf = source if isinstance(source, bytearray) else bytearray(source)
        size = len(buf)
    n = (size >> 3) << 3
    buf[:n] = dictionary_array(size, literal=literal, seed=seed)[:n].tobytes()
    return buf

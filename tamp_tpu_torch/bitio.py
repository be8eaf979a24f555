"""MSB-first bit stream I/O of the streaming codec (the port's copy of
``tamp_tpu.bitio``).

The Tamp stream is a tightly packed MSB-first bit stream (spec:
docs/source/specification.rst "Stream Encoding/Decoding").  These classes
implement the streaming contract the reference exposes
(tamp/compressor.py:36-87, tamp/decompressor.py:41-110) with an unbounded
Python-int accumulator instead of a fixed 32/64-bit register: simpler, and
lets callers queue arbitrarily many bits before draining.
"""

from __future__ import annotations

from .constants import FLUSH_BITS, FLUSH_CODE

__all__ = ["BitWriter", "BitReader"]


class BitWriter:
    """Accumulates bits MSB-first and drains whole bytes to a binary stream."""

    __slots__ = ("f", "_acc", "_nbits", "flush_token_written", "close_f_on_close")

    def __init__(self, f, close_f_on_close: bool = False):
        self.f = f
        self._acc = 0  # pending bits, right-aligned
        self._nbits = 0
        self.flush_token_written = False
        self.close_f_on_close = close_f_on_close

    @property
    def pending_bits(self) -> int:
        return self._nbits

    def write(self, value: int, nbits: int, drain: bool = True) -> int:
        """Queue ``nbits`` bits of ``value`` (LSB-aligned); drain whole bytes."""
        self._acc = (self._acc << nbits) | (int(value) & ((1 << nbits) - 1))
        self._nbits += nbits
        return self._drain() if drain else 0

    def _drain(self) -> int:
        written = 0
        while self._nbits >= 8:
            shift = self._nbits - 8
            self.f.write(bytes(((self._acc >> shift) & 0xFF,)))
            self._acc &= (1 << shift) - 1
            self._nbits -= 8
            written += 1
        return written

    def flush(self, write_token: bool = True, force_token: bool = False) -> int:
        """Byte-align the stream, optionally emitting a FLUSH token first.

        Mirrors the reference contract: the FLUSH code is written when
        requested and either bits are pending or ``force_token`` is set; the
        remainder is zero-padded to the byte boundary.
        """
        written = 0
        self.flush_token_written = False
        if write_token and (self._nbits > 0 or force_token):
            written += self.write(FLUSH_CODE, FLUSH_BITS)
            self.flush_token_written = True
        if self._nbits:
            pad = 8 - self._nbits
            self.f.write(bytes(((self._acc << pad) & 0xFF,)))
            self._acc = 0
            self._nbits = 0
            written += 1
        self.f.flush()
        return written

    def close(self) -> None:
        self.flush(write_token=False)
        if self.close_f_on_close:
            self.f.close()


class BitReader:
    """Reads an MSB-first bit stream with transactional (atomic) reads.

    ``transaction()`` snapshots consumed-but-unreturned bits so a partial
    token read that hits end-of-input can be rolled back — the resumable
    semantics the reference gets from its backup/restore context manager
    (tamp/decompressor.py:95-110).
    """

    __slots__ = ("f", "_acc", "_nbits", "_txn_bits", "close_f_on_close")

    def __init__(self, f, close_f_on_close: bool = False):
        self.f = f
        self._acc = 0
        self._nbits = 0
        self._txn_bits = None  # list of (value, nbits) consumed this txn
        self.close_f_on_close = close_f_on_close

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            b = self.f.read(1)
            if not b:
                raise EOFError
            # Non-conforming file objects may return more than requested;
            # every returned byte is stream data, so consume them all
            # (dropping the excess would silently corrupt the bit stream).
            for byte in b:
                self._acc = (self._acc << 8) | byte
            self._nbits += 8 * len(b)
        shift = self._nbits - nbits
        value = self._acc >> shift
        self._acc &= (1 << shift) - 1
        self._nbits -= nbits
        if self._txn_bits is not None:
            self._txn_bits.append((value, nbits))
        return value

    def clear(self) -> None:
        """Discard buffered bits up to the next byte boundary (post-FLUSH)."""
        self._acc = 0
        self._nbits = 0
        self._txn_bits = None

    def __enter__(self):
        self._txn_bits = []
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._txn_bits:
            # Push consumed bits back, oldest first.
            acc, nbits = self._acc, self._nbits
            restored = 0
            total = 0
            for value, n in self._txn_bits:
                restored = (restored << n) | value
                total += n
            self._acc = (restored << nbits) | acc
            self._nbits = total + nbits
        self._txn_bits = None

    def close(self) -> None:
        if self.close_f_on_close:
            self.f.close()

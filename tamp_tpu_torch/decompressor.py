"""Streaming Tamp decompressor (host code; the port's copy of
``tamp_tpu.decompressor``).

Decodes any spec-conforming Tamp stream bit-exactly: v1 and extended formats,
FLUSH / double-FLUSH dictionary resets, custom and oversized dictionaries,
output-limited reads with overflow carry.  Behavioral spec: BrianPugh/tamp
tamp/decompressor.py:146-433 and docs/source/specification.rst.  Like the
reference's Python decoder it reads a reference outside the window
permissively (modulo the window); the native stream
(:class:`tamp_tpu_torch.stream.NativeDecompressor`) and the card's decoder
(:func:`tamp_tpu_torch.decompress`) raise OutOfBoundsError there.
"""

from __future__ import annotations

from io import BytesIO

from .bitio import BitReader
from .constants import (
    EXTENDED_MATCH_SYMBOL,
    EXTENDED_MATCH_TRAILING_BITS,
    FLUSH_SYMBOL,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    NUM_SYMBOLS,
    RLE_MAX_WINDOW_WRITE,
    RLE_SYMBOL,
    RLE_TRAILING_BITS,
    compute_min_pattern_size,
)
from .dictionary import initialize_dictionary

__all__ = ["Decompressor", "TextDecompressor", "decompress"]

# Prefix-free code lookup: key = (1 << nbits) | code  (the marker bit makes
# equal-valued codes of different lengths distinct).
_CODE_LOOKUP = {
    (1 << (HUFFMAN_LENGTHS[s] - 1)) | (HUFFMAN_CODES[s] & ((1 << (HUFFMAN_LENGTHS[s] - 1)) - 1)): s
    for s in range(NUM_SYMBOLS)
}
_MAX_CODE_BITS = 8


class Decompressor:
    """Decompresses a file or stream of Tamp-compressed data."""

    def __init__(self, f, *, dictionary=None):
        if not hasattr(f, "read"):
            f = open(str(f), "rb")
            close_f = True
        else:
            close_f = False
        self._reader = BitReader(f, close_f_on_close=close_f)

        header = self._reader.read(8)
        self.window_bits = (header >> 5) + 8
        self.literal_bits = ((header >> 3) & 0b11) + 5
        uses_custom = (header >> 2) & 1
        self.extended = bool((header >> 1) & 1)
        self.dictionary_reset = bool(header & 1)
        if self.dictionary_reset:
            if self._reader.read(8):  # header byte 2: reserved, must be zero
                raise ValueError("Reserved bits in header byte 2 must be zero.")

        if uses_custom and dictionary is None:
            raise ValueError("Stream requires a custom dictionary.")

        ws = 1 << self.window_bits
        self.window_size = ws
        init_literal = self.literal_bits if self.extended else 8
        if dictionary is not None:
            if len(dictionary) < ws:
                raise ValueError("Dictionary-window size mismatch.")
            if not uses_custom:
                # Initialize the supplied buffer's window region in place.
                if len(dictionary) == ws:
                    initialize_dictionary(dictionary, literal=init_literal)
                else:
                    dictionary[:ws] = initialize_dictionary(ws, literal=init_literal)
            self._window = dictionary  # may be oversized; only [:ws] is used
        else:
            self._window = initialize_dictionary(ws, literal=init_literal)
        self._pos = 0

        self.min_pattern_size = compute_min_pattern_size(self.window_bits, self.literal_bits)
        self._last_was_flush = False
        self._overflow = bytearray()

    # -- primitives --------------------------------------------------------

    def _read_symbol(self) -> int:
        """Decode one Huffman symbol (flag bit already consumed)."""
        key = 1
        for _ in range(_MAX_CODE_BITS):
            key = (key << 1) | self._reader.read(1)
            sym = _CODE_LOOKUP.get(key)
            if sym is not None:
                return sym
        raise ValueError("Invalid Huffman code in stream.")

    def _read_extended_value(self, trailing_bits: int) -> int:
        sym = self._read_symbol()
        return (sym << trailing_bits) | self._reader.read(trailing_bits)

    def _window_get(self, index: int, size: int) -> bytes:
        ws = self.window_size
        w = self._window
        end = index + size
        if end <= ws:
            return bytes(w[index:end])
        out = bytearray(w[index:ws])
        while len(out) < size:  # modulo wrap, possibly multiple times
            take = min(size - len(out), ws)
            out += w[:take]
        return bytes(out[:size])

    def _window_push(self, data) -> None:
        ws = self.window_size
        pos = self._pos
        w = self._window
        for b in data:
            w[pos] = b
            pos += 1
            if pos == ws:
                pos = 0
        self._pos = pos

    @property
    def _last_window_byte(self) -> int:
        return self._window[self._pos - 1 if self._pos else self.window_size - 1]

    def _reset_window(self) -> None:
        """Double-FLUSH dictionary reset: fresh default window, pos = 0."""
        self._window = initialize_dictionary(
            self.window_size, literal=self.literal_bits if self.extended else 8
        )
        self._pos = 0

    # -- token decode ------------------------------------------------------

    def _next_chunk(self):
        """Decode one token; returns output bytes, or None on FLUSH."""
        is_literal = self._reader.read(1)
        if is_literal:
            self._last_was_flush = False
            chunk = bytes((self._reader.read(self.literal_bits),))
            self._window_push(chunk)
            return chunk

        sym = self._read_symbol()
        if sym == FLUSH_SYMBOL:
            self._reader.clear()  # discard padding to the byte boundary
            if self.dictionary_reset and self._last_was_flush:
                self._reset_window()
            self._last_was_flush = True
            return None
        self._last_was_flush = False

        if self.extended and sym > 11:
            if sym == RLE_SYMBOL:
                count = self._read_extended_value(RLE_TRAILING_BITS) + 2
                chunk = bytes((self._last_window_byte,)) * count
                wr = min(count, RLE_MAX_WINDOW_WRITE, self.window_size - self._pos)
                self._window_push(chunk[:wr])
                return chunk
            # Extended match.
            size = self._read_extended_value(EXTENDED_MATCH_TRAILING_BITS)
            size += self.min_pattern_size + 12
            index = self._reader.read(self.window_bits)
            chunk = self._window_get(index, size)
            wr = min(size, self.window_size - self._pos)  # no wrap-around write
            self._window_push(chunk[:wr])
            return chunk

        size = sym + self.min_pattern_size
        index = self._reader.read(self.window_bits)
        chunk = self._window_get(index, size)
        self._window_push(chunk)
        return chunk

    # -- public API --------------------------------------------------------

    def readinto(self, buf) -> int:
        """Decompress into ``buf``; returns the number of bytes written."""
        n = len(buf)
        written = 0
        if self._overflow:
            take = min(len(self._overflow), n)
            buf[:take] = self._overflow[:take]
            del self._overflow[:take]
            written = take
            if written == n:
                return written

        while written < n:
            try:
                with self._reader:
                    chunk = self._next_chunk()
            except EOFError:
                break
            if chunk is None:
                continue
            take = min(len(chunk), n - written)
            buf[written : written + take] = chunk[:take]
            written += take
            if take < len(chunk):
                self._overflow[:] = chunk[take:]
                break
        return written

    def read(self, size: int = -1):
        """Decompress up to ``size`` bytes (all remaining if negative)."""
        if size == 0:
            return bytearray()
        if size > 0:
            buf = bytearray(size)
            got = self.readinto(buf)
            return buf if got == size else buf[:got]
        out = bytearray()
        chunk_size = 1 << 20
        while True:
            buf = bytearray(chunk_size)
            got = self.readinto(buf)
            out += buf[:got] if got < len(buf) else buf
            if got < len(buf):
                break
            chunk_size <<= 1
        return out

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "Decompressor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class TextDecompressor(Decompressor):
    """Decompresses Tamp data into text (UTF-8)."""

    def read(self, size: int = -1) -> str:  # type: ignore[override]
        return bytes(super().read(size)).decode()


def decompress(data: bytes, *, dictionary=None) -> bytearray:
    """One-shot decompression of a complete Tamp stream."""
    with BytesIO(data) as f:
        return Decompressor(f, dictionary=dictionary).read()

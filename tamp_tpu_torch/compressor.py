"""Streaming Tamp compressor (host code; the port's copy of
``tamp_tpu.compressor``).

The exact, feature-complete streaming encoder: the full config lattice
(window 8-15, literal 5-8, extended, lazy matching, custom dictionaries,
append mode, mid-stream flush, dictionary reset).  It reproduces the
reference encoder's output byte for byte at equal settings (behavioral
spec: BrianPugh/tamp tamp/compressor.py:138-658 and
docs/source/specification.rst).

It runs on the host in both packages, by design: a mid-stream ``flush()``
pads to a byte and leaves a window state and ring position that no device
encoder models (each starts a shard from a fresh window), and a write of a
few bytes at a time is work a kernel launch could only slow.  The card's
encodes are :func:`tamp_tpu_torch.compress` and the containers of
:mod:`tamp_tpu_torch.parallel`; the same stream at native speed is
:class:`tamp_tpu_torch.stream.NativeCompressor`.
"""

from __future__ import annotations

from io import BytesIO

from .bitio import BitWriter
from .constants import (
    EXTENDED_MATCH_SYMBOL,
    EXTENDED_MATCH_TRAILING_BITS,
    FLUSH_BITS,
    FLUSH_CODE,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    INPUT_BUFFER_SIZE,
    RLE_MAX_COUNT,
    RLE_MAX_WINDOW_WRITE,
    RLE_SYMBOL,
    RLE_TRAILING_BITS,
    compute_min_pattern_size,
    max_pattern_size,
)
from .dictionary import initialize_dictionary
from .exceptions import ExcessBitsError

__all__ = ["Compressor", "TextCompressor", "compress"]


class Compressor:
    """Compresses data to a file or stream (streaming, resumable)."""

    def __init__(
        self,
        f,
        *,
        window: int = 10,
        literal: int = 8,
        dictionary=None,
        lazy_matching: bool = False,
        extended: bool = True,
        dictionary_reset: bool = False,
        append: bool = False,
    ):
        self.window_bits = int(window)
        self.literal_bits = int(literal)
        self.extended = bool(extended)
        self.lazy_matching = bool(lazy_matching)
        self.dictionary_reset = bool(dictionary_reset)
        self.min_pattern_size = compute_min_pattern_size(window, literal)
        self.max_pattern_size = max_pattern_size(window, literal, self.extended)
        self.window_size = 1 << self.window_bits

        if dictionary is not None and len(dictionary) != self.window_size:
            raise ValueError("Dictionary-window size mismatch.")

        if not hasattr(f, "write"):
            f = open(str(f), "wb")
            close_f = True
        else:
            close_f = False
        self._writer = BitWriter(f, close_f_on_close=close_f)

        # Debug/metrics callbacks (observability parity with the reference:
        # tamp/compressor.py:220-226).
        self.match_cb = None
        self.extended_match_cb = None
        self.literal_cb = None
        self.flush_cb = None
        self.rle_cb = None
        self.input_index = 0

        self._init_state(dictionary)

        if append:
            if not dictionary_reset:
                raise ValueError("append=True requires dictionary_reset=True")
            if dictionary:
                raise ValueError("append=True cannot use a custom dictionary")
            # No header: emit a FLUSH padded to two bytes.  Together with the
            # previous stream's trailing FLUSH this forms the double-FLUSH
            # dictionary-reset signal.
            self._writer.write(FLUSH_CODE, FLUSH_BITS, drain=False)
            self._writer.write(0, 16 - FLUSH_BITS, drain=True)
            self._last_was_flush = True
        else:
            header = (
                ((self.window_bits - 8) << 5)
                | ((self.literal_bits - 5) << 3)
                | ((1 if dictionary is not None else 0) << 2)
                | ((1 if self.extended else 0) << 1)
                | (1 if dictionary_reset else 0)
            )
            self._writer.write(header, 8, drain=False)
            if dictionary_reset:
                self._writer.write(0, 8, drain=False)  # header byte 2 (reserved)

    # -- state ------------------------------------------------------------

    def _init_state(self, dictionary=None) -> None:
        if dictionary is not None:
            self._window = dictionary
        else:
            self._window = initialize_dictionary(
                self.window_size,
                literal=self.literal_bits if self.extended else 8,
            )
        self._pos = 0  # next ring slot to be overwritten
        self._pending = bytearray()  # look-ahead input buffer (<= 16 bytes)
        self._rle_count = 0
        self._ext_count = 0
        self._ext_pos = 0
        self._lazy_index = -1
        self._lazy_size = 0
        self._last_was_flush = False

    @property
    def _last_window_byte(self) -> int:
        return self._window[self._pos - 1 if self._pos else self.window_size - 1]

    # -- window primitives ------------------------------------------------

    def _window_push(self, data) -> None:
        """Write bytes into the ring with wrap-around."""
        w, size = self._window, self.window_size
        pos = self._pos
        for b in data:
            w[pos] = b
            pos += 1
            if pos == size:
                pos = 0
        self._pos = pos

    def _window_get(self, index: int, size: int) -> bytes:
        """Read ``size`` bytes starting at ring index, wrapping modulo."""
        w, ws = self._window, self.window_size
        end = index + size
        if end <= ws:
            return bytes(w[index:end])
        return bytes(w[index:ws]) + bytes(w[: end - ws])

    def _window_selfcopy(self, src: int, size: int) -> None:
        """Copy window bytes to the write head, stopping at the ring end."""
        n = min(size, self.window_size - self._pos)
        data = self._window_get(src, n)  # snapshot before writing
        self._window[self._pos : self._pos + n] = data
        self._pos += n
        if self._pos == self.window_size:
            self._pos = 0

    # -- searching --------------------------------------------------------

    def _find_longest(self, target, start: int = 0):
        """Longest prefix of ``target`` present in the window as a linear
        buffer, searching indices >= ``start``.

        Returns ``(index, size)`` where ``size`` may be below
        ``min_pattern_size`` (including 0) when no useful match exists; the
        index of the first (lowest) occurrence of the winning prefix is
        returned, mirroring the reference's greedy prefix-growing scan
        (tamp/compressor.py:432-447).
        """
        limit = min(len(target), self.max_pattern_size)
        size = self.min_pattern_size
        if limit < size:
            return start, 0
        idx = self._window.find(target[:size], start)
        if idx < 0:
            return start, size - 1
        while size < limit:
            nxt = self._window.find(target[: size + 1], idx)
            if nxt < 0:
                break
            idx = nxt
            size += 1
        return idx, size

    # -- token emission ---------------------------------------------------

    def _emit_huffman(self, symbol: int) -> int:
        return self._writer.write(HUFFMAN_CODES[symbol], HUFFMAN_LENGTHS[symbol])

    def _emit_extended_value(self, value: int, trailing_bits: int) -> int:
        """Secondary Huffman + trailing-bits encoding for RLE/ext-match."""
        mask = (1 << trailing_bits) - 1
        if value < 0 or value > (14 << trailing_bits) + mask:
            raise ValueError(f"extended value {value} out of range")
        sym = value >> trailing_bits
        n = self._writer.write(HUFFMAN_CODES[sym], HUFFMAN_LENGTHS[sym] - 1)
        n += self._writer.write(value & mask, trailing_bits)
        return n

    def _emit_literal(self, byte: int) -> int:
        if byte >> self.literal_bits:
            raise ExcessBitsError
        if self.literal_cb:
            self.literal_cb(byte)
        n = self._writer.write((1 << self.literal_bits) | byte, self.literal_bits + 1)
        self._window_push((byte,))
        return n

    def _emit_match(self, index: int, match) -> int:
        if self.match_cb:
            self.match_cb(self._pos, index, len(match), bytes(match))
        n = self._emit_huffman(len(match) - self.min_pattern_size)
        n += self._writer.write(index, self.window_bits)
        self._window_push(match)
        return n

    def _emit_rle(self) -> int:
        count, self._rle_count = self._rle_count, 0
        byte = self._last_window_byte
        if count == 0:
            raise ValueError("No RLE run to emit.")
        if count == 1:
            # A lone carried run byte degenerates to a literal.
            return self._emit_literal(byte)
        if self.rle_cb:
            self.rle_cb(count, byte)
        n = self._emit_huffman(RLE_SYMBOL)
        n += self._emit_extended_value(count - 2, RLE_TRAILING_BITS)
        # Window keeps at most 8 run bytes, never wrapping past the ring end.
        wr = min(count, RLE_MAX_WINDOW_WRITE, self.window_size - self._pos)
        self._window_push(bytes((byte,)) * wr)
        return n

    def _emit_extended_match(self) -> int:
        if self.extended_match_cb:
            self.extended_match_cb(
                self._pos, self._ext_pos, self._ext_count, self._window_get(self._ext_pos, self._ext_count)
            )
        n = self._emit_huffman(EXTENDED_MATCH_SYMBOL)
        n += self._emit_extended_value(
            self._ext_count - self.min_pattern_size - 12, EXTENDED_MATCH_TRAILING_BITS
        )
        n += self._writer.write(self._ext_pos, self.window_bits)
        self._window_selfcopy(self._ext_pos, self._ext_count)
        self._ext_count = 0
        self._ext_pos = 0
        return n

    # -- the per-token state machine --------------------------------------

    def _step(self) -> int:
        """Process the pending buffer far enough to emit (at most) one token.

        Mirrors the reference's single-token poll
        (tamp/compressor.py:281-430): extended-match continuation, then RLE
        accumulation/decision, then (lazy) pattern matching.
        """
        if not self._pending:
            return 0
        written = 0
        self._last_was_flush = False

        # Extended-match continuation: grow the held match one byte at a time.
        if self._ext_count:
            self._lazy_index = -1
            while self._pending:
                if self._ext_pos + self._ext_count >= self.window_size:
                    # Ring-end boundary: emit without wrap-around.
                    return written + self._emit_extended_match()
                target = self._window_get(self._ext_pos, self._ext_count)
                target += bytes((self._pending[0],))
                idx, size = self._find_longest(target, start=self._ext_pos)
                if size > self._ext_count:
                    del self._pending[0]
                    self._ext_count = size
                    self._ext_pos = idx
                    if self._ext_count == self.max_pattern_size:
                        return written + self._emit_extended_match()
                else:
                    return written + self._emit_extended_match()
            return written  # drained input while growing; wait for more

        # RLE accumulation (extended format only).
        if self.extended:
            last = self._last_window_byte
            avail = 0
            for b in self._pending:
                if b == last and self._rle_count + avail < RLE_MAX_COUNT:
                    avail += 1
                else:
                    break
            total = self._rle_count + avail
            ended = avail < len(self._pending) or total >= RLE_MAX_COUNT

            if not ended and total > 0:
                # Run may continue into future input: absorb and wait.
                self._lazy_index = -1
                self._rle_count = total
                del self._pending[:avail]
                return written

            if total >= 2:
                use_pattern = False
                if total == avail and total <= 6:
                    # Short fresh run: prefer a longer pattern match if one exists.
                    _, size = self._find_longest(bytes(self._pending))
                    if size > total:
                        use_pattern = True
                if not use_pattern:
                    self._lazy_index = -1
                    del self._pending[:avail]
                    self._rle_count = total
                    return written + self._emit_rle()
                self._rle_count = 0
            elif total == 1:
                if self._rle_count == 1:
                    # The lone byte was consumed in a prior cycle; emit it now.
                    self._lazy_index = -1
                    return written + self._emit_rle()
                self._rle_count = 0

        # Pattern matching.
        target = bytes(self._pending)
        if self.lazy_matching and self._lazy_index >= 0:
            idx, size = self._lazy_index, self._lazy_size
            match = self._window_get(idx, size)
            self._lazy_index = -1
        else:
            idx, size = self._find_longest(target)
            match = target[:size]

        if (
            self.lazy_matching
            and self.min_pattern_size <= size <= 8
            and len(self._pending) > size + 2
        ):
            nxt_idx, nxt_size = self._find_longest(target[1:])
            # Take the later, longer match only if writing this literal can't
            # clobber its source bytes.
            if nxt_size > size and not (nxt_idx <= self._pos < nxt_idx + nxt_size):
                byte = self._pending.pop(0)
                written += self._emit_literal(byte)
                self._lazy_index = nxt_idx
                self._lazy_size = nxt_size
                return written

        if size >= self.min_pattern_size:
            if self.extended and size > self.min_pattern_size + 11:
                # Long match: hold as extended-match state to keep growing.
                self._ext_pos = idx
                self._ext_count = size
            else:
                written += self._emit_match(idx, match)
            del self._pending[:size]
        else:
            byte = self._pending.pop(0)
            written += self._emit_literal(byte)
        return written

    # -- public API --------------------------------------------------------

    def write(self, data) -> int:
        """Compress ``data``; returns compressed bytes written so far."""
        if isinstance(data, str):
            raise TypeError("Compressor.write expects bytes; use TextCompressor for str")
        written = 0
        pos = 0
        n = len(data)
        self.input_index = 0
        while pos < n:
            take = INPUT_BUFFER_SIZE - len(self._pending)
            if take > 0:
                grab = data[pos : pos + take]
                self._pending.extend(grab)
                pos += len(grab)
                self.input_index = pos
            if len(self._pending) == INPUT_BUFFER_SIZE:
                written += self._step()
        return written

    def flush(self, write_token: bool = True) -> int:
        """Drain all internal buffers and byte-align the output.

        A FLUSH token is emitted when requested unless the previous token was
        itself a FLUSH (two consecutive FLUSHes signal a dictionary reset on
        ``dictionary_reset`` streams; accidental doubles are suppressed).
        """
        written = 0
        if self.flush_cb:
            self.flush_cb()
        while self._pending:
            written += self._step()
        if self.extended and self._rle_count:
            written += self._emit_rle()
        if self.extended and self._ext_count:
            written += self._emit_extended_match()
        if self.lazy_matching:
            self._lazy_index = -1
            self._lazy_size = 0
        emit = write_token and not self._last_was_flush
        written += self._writer.flush(write_token=emit, force_token=self.dictionary_reset)
        if self._writer.flush_token_written:
            self._last_was_flush = True
        return written

    def reset_dictionary(self) -> int:
        """Emit a double-FLUSH reset signal and re-initialize all state."""
        if not self.dictionary_reset:
            raise ValueError("Compressor was not initialized with dictionary_reset=True")
        written = 0
        for _ in range(2):
            self._last_was_flush = False  # deliberately bypass suppression
            written += self.flush(write_token=True)
        self._init_state()
        return written

    def close(self) -> int:
        # dictionary_reset streams always end on a FLUSH so that a future
        # append-mode stream can complete the double-FLUSH signal.
        written = self.flush(write_token=self.dictionary_reset)
        self._writer.close()
        return written

    def __enter__(self) -> "Compressor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class TextCompressor(Compressor):
    """Compresses text (UTF-8) to a file or stream."""

    def write(self, data: str) -> int:  # type: ignore[override]
        return super().write(data.encode())


def compress(
    data,
    *,
    window: int = 10,
    literal: int = 8,
    dictionary=None,
    lazy_matching: bool = False,
    extended: bool = True,
) -> bytes:
    """One-shot compression returning the full Tamp stream."""
    with BytesIO() as f:
        cls = TextCompressor if isinstance(data, str) else Compressor
        c = cls(
            f,
            window=window,
            literal=literal,
            dictionary=dictionary,
            lazy_matching=lazy_matching,
            extended=extended,
        )
        c.write(data)
        c.flush(write_token=False)
        return f.getvalue()

"""Native streaming codec: file-like incremental compress and decompress
over the port's C++ stream handles (``csrc/stream.cpp``).

The port's counterpart of the JAX package's ``_native/stream.py``.  The
output is byte-identical to the Python streaming codec
(:class:`tamp_tpu_torch.Compressor`), and both equal the reference
encoder, so the two are interchangeable.  Host code, as in the JAX
package: a stream's mid-stream flushes and small writes have no device
counterpart (see :mod:`tamp_tpu_torch.compressor`).  The library is built
by :mod:`tamp_tpu_torch.ops._build` at the first stream; a failed build
raises, and nothing falls back to the Python classes.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

from .constants import compute_min_pattern_size
from .exceptions import AbortedError, ExcessBitsError, OutOfBoundsError

__all__ = ["NativeCompressor", "NativeDecompressor", "CALLBACK_CFUNC"]

# int cb(void* user, int64_t bytes_in, int64_t bytes_out)
CALLBACK_CFUNC = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64)
_ABORT_RC = -100  # the trampoline's stop code: outside the handles' statuses
_OUT_CAP = 1 << 16

_lib_bound = None


def _lib():
    """The stream library, its entries' signatures set (built on first use)."""
    global _lib_bound
    if _lib_bound is None:
        from .ops import _build

        lib = _build.load("stream")
        vp, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
        i64, i64p, cint = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), \
            ctypes.c_int
        sigs = {
            "tpt_stream_comp_new": ([cint, cint, cint, cint, u8p, cint, cint],
                                    vp),
            "tpt_stream_comp_free": ([vp], None),
            "tpt_stream_comp_write": ([vp, u8p, i64, u8p, i64, i64p], cint),
            "tpt_stream_comp_flush": ([vp, cint, u8p, i64, i64p], cint),
            "tpt_stream_comp_reset_dictionary": ([vp, u8p, i64, i64p], cint),
            "tpt_stream_comp_set_callback": ([vp, CALLBACK_CFUNC, vp], None),
            "tpt_stream_dec_new": ([u8p, i64], vp),
            "tpt_stream_dec_free": ([vp], None),
            "tpt_stream_dec_feed": ([vp, u8p, i64], cint),
            "tpt_stream_dec_read": ([vp, u8p, i64, i64p], cint),
            "tpt_stream_dec_set_callback": ([vp, CALLBACK_CFUNC, vp], None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib_bound = lib
    return _lib_bound


def _u8(buf):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _make_trampoline(owner, callback):
    """Wrap a Python ``cb(bytes_in, bytes_out)`` as a C callback.  A truthy
    return, or an exception (kept on ``owner`` to raise again), stops the
    native call in flight with ``_ABORT_RC``."""

    def tramp(_user, bytes_in, bytes_out):
        try:
            return _ABORT_RC if callback(bytes_in, bytes_out) else 0
        except BaseException as e:  # carried across the C frame
            owner._cb_exc = e
            return _ABORT_RC

    return CALLBACK_CFUNC(tramp)


def _raise_abort(owner):
    exc, owner._cb_exc = owner._cb_exc, None
    if exc is not None:
        raise exc
    raise AbortedError("progress callback requested abort")


def _set_callback(owner, setter, callback) -> None:
    if callback is None:
        owner._cb_ref = None
        setter(owner._h, ctypes.cast(None, CALLBACK_CFUNC), None)
        return
    owner._cb_ref = _make_trampoline(owner, callback)
    setter(owner._h, owner._cb_ref, None)


class NativeCompressor:
    """Incremental Tamp compressor writing to a binary file object (or a
    path), the reference encoder's stream at native speed."""

    def __init__(self, f, *, window: int = 10, literal: int = 8,
                 dictionary=None, dictionary_reset: bool = False,
                 lazy_matching: bool = False, extended: bool = True,
                 append: bool = False):
        compute_min_pattern_size(window, literal)  # validates the config
        if append and not dictionary_reset:
            raise ValueError("append=True requires dictionary_reset=True")
        if append and dictionary is not None:
            raise ValueError("append=True cannot use a custom dictionary")
        dict_arr = None
        if dictionary is not None:
            dict_arr = np.frombuffer(bytes(dictionary), dtype=np.uint8)
            if dict_arr.shape[0] != (1 << window):
                raise ValueError("Dictionary-window size mismatch.")
        self._h = None
        self._lib = lib = _lib()
        self._close_f = False
        if not hasattr(f, "write"):  # path-like
            f = open(str(f), "wb")
            self._close_f = True
        self.f = f
        self.dictionary_reset = dictionary_reset
        self._h = lib.tpt_stream_comp_new(
            window, literal, int(extended), int(lazy_matching),
            None if dict_arr is None else _u8(dict_arr),
            int(dictionary_reset), int(append))
        self._out = np.empty(_OUT_CAP, dtype=np.uint8)
        self._cb_ref = None
        self._cb_exc = None

    def set_progress_callback(self, callback) -> None:
        """Register ``cb(bytes_in, bytes_out)``, fired every 256 tokens with
        the input consumed and output emitted so far.  A truthy return stops
        the ``write()`` or ``flush()`` in flight with
        :class:`~tamp_tpu_torch.exceptions.AbortedError`; the stream stays
        token-consistent, so the call may be issued again to resume (a
        resumed ``write`` passes ``b""``: the rest of the input is held).
        ``None`` clears it."""
        _set_callback(self, self._lib.tpt_stream_comp_set_callback, callback)

    def _call(self, fn, *head, drain_head=None) -> int:
        """Call a stream entry, writing its output on; on output full (rc 1)
        call again, with ``drain_head`` in place of ``head`` where given (a
        write must not pass its input twice)."""
        written = 0
        args = head
        while True:
            n = ctypes.c_int64(0)
            rc = fn(self._h, *args, _u8(self._out), self._out.shape[0],
                    ctypes.byref(n))
            if n.value:
                self.f.write(self._out[: n.value].tobytes())
                written += n.value
            if rc == 0:
                return written
            if rc == 1:
                if drain_head is not None:
                    args = drain_head
                continue
            if rc == -2:
                raise ExcessBitsError
            if rc == _ABORT_RC:
                _raise_abort(self)
            raise RuntimeError(f"native stream error rc={rc}")

    def write(self, data) -> int:
        """Compress ``data``; returns the compressed bytes written."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        n = arr.shape[0]
        return self._call(self._lib.tpt_stream_comp_write,
                          _u8(arr) if n else None, ctypes.c_int64(n),
                          drain_head=(None, ctypes.c_int64(0)))

    def flush(self, write_token: bool = True) -> int:
        """Drain the held input and byte-align the output, with a FLUSH token
        unless ``write_token`` is false or the last token was a FLUSH."""
        return self._call(self._lib.tpt_stream_comp_flush, int(write_token))

    def reset_dictionary(self) -> int:
        """Emit the double-FLUSH reset and start again from a fresh window."""
        if not self.dictionary_reset:
            raise ValueError(
                "Compressor was not initialized with dictionary_reset=True")
        return self._call(self._lib.tpt_stream_comp_reset_dictionary)

    def close(self) -> int:
        if self._h is None:
            return 0
        written = self.flush(write_token=self.dictionary_reset)
        self._lib.tpt_stream_comp_free(self._h)
        self._h = None
        if self._close_f:
            self.f.close()
        return written

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.tpt_stream_comp_free(self._h)
            self._h = None


class NativeDecompressor:
    """Incremental Tamp decompressor reading a binary file object, a path
    or a bytes object.  A reference outside the window raises
    OutOfBoundsError, as the native decoder does."""

    def __init__(self, f, *, dictionary=None):
        self._h = None
        self._lib = lib = _lib()
        self._close_f = False
        if isinstance(f, (bytes, bytearray)):
            f = io.BytesIO(f)
        elif not hasattr(f, "read"):  # path-like
            f = open(str(f), "rb")
            self._close_f = True
        self.f = f
        dict_arr = None
        if dictionary is not None:
            dict_arr = np.frombuffer(bytes(dictionary), dtype=np.uint8)
        self._h = lib.tpt_stream_dec_new(
            None if dict_arr is None else _u8(dict_arr),
            0 if dict_arr is None else dict_arr.shape[0])
        self._eof = False
        self._cb_ref = None
        self._cb_exc = None
        # Read the header now (and the reserved byte of a ``more`` stream),
        # as the reference's binding does: a missing or short dictionary
        # raises here, not mid-stream.
        hdr = self.f.read(1)
        if hdr:
            if hdr[0] & 1:
                hdr += self.f.read(1)
            arr = np.frombuffer(hdr, dtype=np.uint8)
            lib.tpt_stream_dec_feed(self._h, _u8(arr), arr.shape[0])
            out = np.empty(1, dtype=np.uint8)
            n = ctypes.c_int64(0)
            rc = lib.tpt_stream_dec_read(self._h, _u8(out), 0,
                                         ctypes.byref(n))
            if rc != 0:
                raise ValueError(
                    "invalid header or dictionary-window size mismatch "
                    f"(native rc={rc})")
        else:
            self._eof = True

    def set_progress_callback(self, callback) -> None:
        """Register ``cb(bytes_in, bytes_out)``, fired every 1024 tokens; the
        contract of :meth:`NativeCompressor.set_progress_callback` (a stopped
        ``readinto`` keeps the bytes it decoded in its buffer)."""
        _set_callback(self, self._lib.tpt_stream_dec_set_callback, callback)

    def readinto(self, buf) -> int:
        """Decompress into ``buf``; returns the number of bytes written."""
        view = memoryview(buf)
        out = np.empty(len(view), dtype=np.uint8)
        filled = 0
        while filled < len(view):
            n = ctypes.c_int64(0)
            rc = self._lib.tpt_stream_dec_read(
                self._h, _u8(out), len(view) - filled, ctypes.byref(n))
            if rc == -4:
                raise OutOfBoundsError("window reference outside the window")
            if rc == _ABORT_RC:
                if n.value:
                    view[filled : filled + n.value] = out[: n.value].tobytes()
                _raise_abort(self)
            if rc != 0:
                raise ValueError(f"invalid tamp stream (native rc={rc})")
            if n.value:
                view[filled : filled + n.value] = out[: n.value].tobytes()
                filled += n.value
                continue
            if self._eof:
                break
            chunk = self.f.read(1 << 16)
            if not chunk:
                self._eof = True
                continue
            arr = np.frombuffer(chunk, dtype=np.uint8)
            self._lib.tpt_stream_dec_feed(self._h, _u8(arr), arr.shape[0])
        return filled

    def read(self, size: int = -1) -> bytearray:
        """Decompress up to ``size`` bytes (all that remain if negative)."""
        if size < 0:
            out = bytearray()
            chunk = bytearray(1 << 16)
            while True:
                n = self.readinto(chunk)
                out += chunk[:n]
                if n < len(chunk):
                    return out
        buf = bytearray(size)
        n = self.readinto(buf)
        del buf[n:]
        return buf

    def close(self) -> None:
        if self._h is not None:
            self._lib.tpt_stream_dec_free(self._h)
            self._h = None
        if self._close_f:
            self.f.close()
            self._close_f = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.tpt_stream_dec_free(self._h)
            self._h = None

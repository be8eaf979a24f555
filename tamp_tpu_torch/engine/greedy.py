"""The host exact-table committer of the greedy-parity encode.

Counterpart of the JAX package's ``_native.native_compress(...,
extended=True, tables=..., exact_tables=True)``: a ctypes binding of the
port's own copy of the native committer (``csrc/greedy_commit.cpp``, built
with the host C++ compiler at first use by ops/_build.py).

:func:`greedy_compress` writes one extended-format Tamp stream that is
byte-equal to the reference greedy encoder (``tamp_tpu.compress(data,
extended=True)``) whatever tables it is given: with none it is that
encoder; with the card's cap-16 (and probe) tables it reads them where they
are exact and searches where they are not or where an entry is a hole
(length ``SPARSE_NONE``).  The call releases the GIL, so commits of several
shards run in parallel threads.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..constants import compute_min_pattern_size
from ..dictionary import dictionary_array
from ..exceptions import ExcessBitsError
from ..ops import _build

__all__ = ["greedy_compress", "SPARSE_NONE"]

SPARSE_NONE = 0xFF  # table length of a position with no shipped entry


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("greedy_commit").tpt_greedy_compress
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _default_dictionary(window: int, literal: int) -> np.ndarray:
    arr = dictionary_array(1 << window, literal=literal)
    arr.setflags(write=False)  # one array shared by every call
    return arr


def _ptr(a):
    return None if a is None else a.ctypes.data


def greedy_compress(data, *, window: int = 10, literal: int = 8,
                    lazy_matching: bool = False, dictionary=None,
                    tables=None) -> bytes:
    """One extended-format Tamp stream of ``data``, header included.

    ``dictionary``: a full-window custom dictionary (bytes or uint8 array),
    else the extended format's default.  ``tables``: None for the
    table-less exact search, else ``(flen, fidx)`` or, with lazy matching,
    ``(flen, fidx, plen, pidx)``: per input position the cap-16 match
    (and the cap-15 probe) as uint8 lengths and int32 ring slots, with
    ``SPARSE_NONE`` lengths at holes.  Raises ExcessBitsError for a byte
    wider than ``literal`` bits."""
    compute_min_pattern_size(window, literal)  # validates the config
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    n = arr.shape[0]
    if dictionary is None:
        dict_arr = _default_dictionary(window, literal)
    else:
        dict_arr = np.ascontiguousarray(
            np.frombuffer(bytes(dictionary), np.uint8))
        if dict_arr.shape[0] != 1 << window:
            raise ValueError("Dictionary-window size mismatch.")
    planes = [None] * 4
    if tables is not None:
        need = 4 if lazy_matching else 2
        if len(tables) < need:
            raise ValueError("lazy matching needs the probe tables")
        for k, a in enumerate(tables[:need]):
            a = np.ascontiguousarray(a, np.uint8 if k % 2 == 0 else np.int32)
            if a.shape != (n,):
                raise ValueError("tables must have one entry per input byte")
            if k % 2 and n and (a.min() < 0 or a.max() >= 1 << window):
                raise ValueError("table ring slots must lie in [0, W)")
            planes[k] = a
    cap = 16 + n + ((n * (1 + literal)) >> 3)
    out = np.empty(cap, np.uint8)
    out_len = ctypes.c_int64(0)
    rc = _entry()(_ptr(arr), n, *(_ptr(p) for p in planes), _ptr(dict_arr),
                  window, literal, int(lazy_matching),
                  int(dictionary is not None), _ptr(out), cap,
                  ctypes.addressof(out_len))
    if rc == -2:
        raise ExcessBitsError
    if rc != 0:
        raise RuntimeError(f"greedy commit failed: rc={rc}")
    return out[: out_len.value].tobytes()

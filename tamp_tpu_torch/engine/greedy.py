"""The host table committer of the device-table encodes.

A ctypes binding of the port's own copy of the JAX package's native
committer (``csrc/greedy_commit.cpp``, built with the host C++ compiler at
first use by ops/_build.py).  Every call releases the GIL, so commits of
several shards run in parallel threads.

:func:`greedy_compress` (counterpart of ``_native.native_compress(...,
extended=True, tables=..., exact_tables=True)``) writes one extended-format
Tamp stream that is byte-equal to the reference greedy encoder
(``tamp_tpu.compress(data, extended=True)``) whatever tables it is given:
with none it is that encoder; with the card's cap-16 (and probe) tables it
reads them where they are exact and searches where they are not or where an
entry is a hole (length ``SPARSE_NONE``).

:func:`table_compress` is the counterpart of ``_native.native_compress``
in table mode for the extended format, with divergence avoidance and the
planned mode (run plans and khat): the committer of the extended
``engine="device"`` (engine/encode_extended.py).

The same library holds the host half of the optimal extended encode
(engine/pipeline_ext.encode_ext_device_optimal): :func:`host_v1_tables`,
the exact tables at any cap with forced RLE's write counts (counterpart of
``_native.native_v1_tables(..., ext_dict=True, khat=...)``), and
:func:`opt_ext_walk`, the expansion of the card's choice plane into tokens
(``_native.native_opt_ext_walk``).  It also holds the host half of the
planned extended encode (engine/pipeline_ext.encode_ext_device_commit,
and the model inputs of ``engine="device"``): :func:`host_ext_prep`, the
one-pass run plan, model history and chunk counts
(``_native.native_ext_prep``), and :func:`host_ext_tail_bits`, the walk
over a shard's last < 16 model bytes after the card's commit
(``_native.native_ext_tail_bits``); engine/plan.py and engine/tail.py are
their plain versions, off the main path.  :func:`host_optimal_v1` is the
minimum-bit v1 parse on the host (``encode_v1(parse="optimal")`` on the
JAX package's native engine), the reference of the card's optimal v1
encode.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..constants import compute_min_pattern_size
from ..dictionary import dictionary_array
from ..exceptions import ExcessBitsError
from ..ops import _build
from .encode import build_header, model_history, pack_bits_np, v1_plan_fields

__all__ = ["greedy_compress", "table_compress", "host_v1_tables",
           "opt_ext_walk", "host_optimal_v1", "host_ext_prep",
           "host_ext_tail_bits", "window_array", "SPARSE_NONE",
           "COMMIT_STATS"]

SPARSE_NONE = 0xFF  # table length of a position with no shipped entry
# The slots of greedy_compress's ``stats``, as the trace's counters name
# them: table lookups, then how each ended (the entry taken without a
# search; a search at a hole; a search seeded from the entry after a
# window truncation; an unseeded search after one).
COMMIT_STATS = ("commit.lookups", "commit.table_hits", "commit.hole_searches",
                "commit.seeded_searches", "commit.full_searches")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_HOST_ARGTYPES = {
    "tpt_greedy_compress": ([_P, _I64] + [_P] * 5 + [_I] * 4
                            + [_P, _I64, _P, _P]),
    "tpt_table_compress": ([_P, _I64] + [_P] * 5 + [_I] * 6
                           + [_P, _P, _I, _P, _I64, _P]),
    "tpt_v1_tables": [_P, _I64, _P, _I, _I, _I, _P, _P, _P],
    "tpt_opt_ext_walk": [_P, _I64, _I, _P, _I, _P, _P, _P],
    "tpt_opt_v1_plan": [_P, _P, _I64, _I, _I, _P, _P],
    "tpt_ext_prep": [_P, _I64, _I, _P, _I64, _P, _P, _P, _P, _P],
    "tpt_ext_tail_bits": ([_P, _I64, _I64, _P, _P, _P, _I, _P, _I, _I, _I,
                           ctypes.c_uint32, _I, _P, _I64, _P]),
}


@functools.lru_cache(maxsize=None)
def _host_entry(name: str):
    fn = getattr(_build.load("greedy_commit"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _HOST_ARGTYPES[name]
    return fn


@functools.lru_cache(maxsize=None)
def _default_dictionary(window: int, literal: int) -> np.ndarray:
    arr = dictionary_array(1 << window, literal=literal)
    arr.setflags(write=False)  # one array shared by every call
    return arr


def _ptr(a):
    return None if a is None else a.ctypes.data


def window_array(window: int, literal: int, dictionary) -> np.ndarray:
    """The initial window: ``dictionary`` (bytes or uint8 array) checked
    against the window size, else the default at ``literal`` (one
    read-only array shared by every call)."""
    if dictionary is None:
        return _default_dictionary(window, literal)
    arr = np.ascontiguousarray(np.frombuffer(bytes(dictionary), np.uint8))
    if arr.shape[0] != 1 << window:
        raise ValueError("Dictionary-window size mismatch.")
    return arr


def _planes(tables, n: int, window: int, lazy: bool) -> list:
    """The committer's four table pointers' arrays (None where absent) from
    ``tables``: None, ``(flen, fidx)`` or ``(flen, fidx, plen, pidx)``."""
    planes = [None] * 4
    if tables is None:
        return planes
    need = 4 if lazy else 2
    if len(tables) < need:
        raise ValueError("lazy matching needs the probe tables")
    for k, a in enumerate(tables[:need]):
        a = np.ascontiguousarray(a, np.uint8 if k % 2 == 0 else np.int32)
        if a.shape != (n,):
            raise ValueError("tables must have one entry per input byte")
        if k % 2 and n and (a.min() < 0 or a.max() >= 1 << window):
            raise ValueError("table ring slots must lie in [0, W)")
        planes[k] = a
    return planes


def _compress(entry: str, arr: np.ndarray, literal: int, *args,
              after=()) -> bytes:
    """Call ``entry`` on ``arr`` with ``args`` between the input and the
    output buffer and ``after`` behind it; raise ExcessBitsError on -2,
    RuntimeError otherwise."""
    n = arr.shape[0]
    cap = 16 + n + ((n * (1 + literal)) >> 3)
    out = np.empty(cap, np.uint8)
    out_len = ctypes.c_int64(0)
    rc = _host_entry(entry)(_ptr(arr), n, *args, _ptr(out), cap,
                            ctypes.addressof(out_len), *after)
    if rc == -2:
        raise ExcessBitsError
    if rc != 0:
        raise RuntimeError(f"table commit failed: rc={rc}")
    return out[: out_len.value].tobytes()


def greedy_compress(data, *, window: int = 10, literal: int = 8,
                    lazy_matching: bool = False, dictionary=None,
                    tables=None, stats=None) -> bytes:
    """One extended-format Tamp stream of ``data``, header included.

    ``dictionary``: a full-window custom dictionary (bytes or uint8 array),
    else the extended format's default.  ``tables``: None for the
    table-less exact search, else ``(flen, fidx)`` or, with lazy matching,
    ``(flen, fidx, plen, pidx)``: per input position the cap-16 match
    (and the cap-15 probe) as uint8 lengths and int32 ring slots, with
    ``SPARSE_NONE`` lengths at holes.  ``stats``: None, or a writable
    (5,) int64 array that receives the counts of :data:`COMMIT_STATS` (the
    stream is the same either way).  Raises ExcessBitsError for a byte
    wider than ``literal`` bits."""
    compute_min_pattern_size(window, literal)  # validates the config
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    dict_arr = window_array(window, literal, dictionary)
    planes = _planes(tables, arr.shape[0], window, lazy_matching)
    if stats is not None and not (
            isinstance(stats, np.ndarray) and stats.dtype == np.int64
            and stats.shape == (len(COMMIT_STATS),)
            and stats.flags.c_contiguous
            and stats.flags.writeable):
        raise ValueError("stats must be a writable (5,) int64 array")
    return _compress("tpt_greedy_compress", arr, literal,
                     *(_ptr(p) for p in planes), _ptr(dict_arr), window,
                     literal, int(lazy_matching), int(dictionary is not None),
                     after=(_ptr(stats),))


def table_compress(data, *, window: int = 10, literal: int = 8,
                   lazy_matching: bool = False, dictionary=None, tables=None,
                   khat=None, plan=None, avoid_divergence: bool = False,
                   force_planned: bool = False) -> bytes:
    """One extended-format Tamp stream of ``data``, header included, from
    per-position match tables in table mode: the JAX package's
    ``_native.native_compress(..., extended=True)`` with ``tables`` as
    arrays.

    ``dictionary``: a full-window custom dictionary, else the default.
    ``tables``: None, ``(flen, fidx)`` or with lazy matching ``(flen,
    fidx, plen, pidx)``, uint8 lengths and int32 ring slots, per input
    position.  ``khat`` (n + 1 model write counts) and ``plan`` ((k, 2)
    (rle_start, end) pairs; an empty plan is no plan) select the planned
    mode; ``force_planned`` selects it without runs too (the native
    committer's ``force_planned``, which needs ``khat``);
    ``avoid_divergence`` splits extended matches at the ring end.  Raises
    ExcessBitsError for a byte wider than ``literal`` bits."""
    compute_min_pattern_size(window, literal)  # validates the config
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    n = arr.shape[0]
    dict_arr = window_array(window, literal, dictionary)
    planes = _planes(tables, n, window, lazy_matching)
    kh = pl = None
    if khat is not None:
        kh = np.ascontiguousarray(khat, np.uint32)
        # a decrease wraps to a step above 1 in uint32
        if kh.shape != (n + 1,) or kh[0] or (np.diff(kh) > 1).any():
            raise ValueError("khat must hold n + 1 write counts, from 0 in "
                             "steps of 0 or 1")
    has_plan = plan is not None and len(plan) > 0
    if (has_plan or force_planned) and kh is None:
        raise ValueError("a run plan requires the khat mapping")
    n_plan = 0
    if has_plan:
        pl = np.ascontiguousarray(plan, np.int64).reshape(-1)
        if pl.shape[0] % 2 or pl.min() < 0 or pl.max() > n or (
                np.diff(pl) < 0).any():
            raise ValueError("plan must hold sorted (rle_start, end) pairs "
                             "inside the input")
        n_plan = pl.shape[0] // 2
    elif force_planned:
        pl = np.zeros(2, np.int64)  # a plan pointer holding no pairs
    return _compress("tpt_table_compress", arr, literal,
                     *(_ptr(p) for p in planes), _ptr(dict_arr), window,
                     literal, int(lazy_matching), int(dictionary is not None),
                     int(avoid_divergence), 0, _ptr(kh), _ptr(pl), n_plan)


def host_v1_tables(data, *, window: int, literal: int, cap: int,
                   dictionary=None, khat=None):
    """(flen uint8, fidx int32): per position of ``data`` the longest match
    (0 below the minimum pattern) against the v1 ring model, capped at
    ``cap``, and its lowest ring slot.  ``dictionary``: the initial window
    (bytes or uint8 array), else the extended format's default at
    ``literal``.  ``khat``: None, or the (n + 1,) uint32 write counts of
    forced RLE (engine/encode.opt_ext_runs); a byte enters the ring only
    where its count rises."""
    compute_min_pattern_size(window, literal)  # validates the config
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    n = arr.shape[0]
    dict_arr = window_array(window, literal, dictionary)
    kh = None
    if khat is not None:
        kh = np.ascontiguousarray(khat, np.uint32)
        if kh.shape != (n + 1,):
            raise ValueError("khat must hold n + 1 write counts")
    flen = np.zeros(max(n, 1), np.uint8)
    fidx = np.zeros(max(n, 1), np.int32)
    rc = _host_entry("tpt_v1_tables")(
        _ptr(arr), n, _ptr(dict_arr), window, literal, cap, _ptr(kh),
        _ptr(flen), _ptr(fidx))
    if rc != 0:
        raise RuntimeError(f"table build failed: rc={rc}")
    return flen[:n], fidx[:n]


def opt_ext_walk(choice, minp: int, runs=()):
    """(sizes uint8, kinds uint8) tokens of a per-position choice plane
    (1 literal, s a match of advance s) with the forced-RLE regions
    ``runs`` ((a, b) pairs) cut into chunks of 241 (240 before a rest of
    2).  kinds: 0 literal, 1 basic, 2 extended, 3 RLE."""
    ch = np.ascontiguousarray(choice, np.uint8)
    n = ch.shape[0]
    rn = np.ascontiguousarray(np.asarray(runs, np.int64).reshape(-1))
    sizes = np.empty(max(n, 1), np.uint8)
    kinds = np.empty(max(n, 1), np.uint8)
    n_tokens = ctypes.c_int64(0)
    rc = _host_entry("tpt_opt_ext_walk")(
        _ptr(ch), n, minp, _ptr(rn) if rn.size else None, rn.size // 2,
        _ptr(sizes), _ptr(kinds), ctypes.addressof(n_tokens))
    if rc != 0:
        raise ValueError(f"optimal choice walk failed: rc={rc}")
    return sizes[: n_tokens.value], kinds[: n_tokens.value]


def host_optimal_v1(data, *, window: int = 10, literal: int = 8,
                    dictionary=None) -> bytes:
    """One v1 stream of the minimum-bit parse, all on the host: the exact
    tables of the v1 window model (:func:`host_v1_tables` at cap
    ``min(16, minp + 13)``), the DP ``tpt_opt_v1_plan`` and the packing
    of engine/encode.py.  The counterpart of the JAX package's
    ``encode_v1(parse="optimal")`` on its native engine; bench_torch.py
    holds the card's optimal v1 encode (kernel X3) to it.
    ExcessBitsError where a byte fits no literal and no match covers it."""
    arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    n = arr.shape[0]
    if n > (200 << 20):  # the DP's uint32 costs: <= 9 bits a byte must fit
        raise ValueError("optimal parse is limited to 200 MiB per stream")
    dict_arr, _ = model_history(arr, window, literal, False, dictionary)
    cap = min(16, compute_min_pattern_size(window, literal) + 13)
    flen, fidx = host_v1_tables(arr, window=window, literal=literal, cap=cap,
                                dictionary=dict_arr)
    sizes = np.empty(max(n, 1), np.uint8)
    n_tokens = ctypes.c_int64(0)
    rc = _host_entry("tpt_opt_v1_plan")(
        _ptr(arr), _ptr(np.ascontiguousarray(flen)), n, window, literal,
        _ptr(sizes), ctypes.addressof(n_tokens))
    if rc == -2:
        raise ExcessBitsError
    if rc != 0:
        raise RuntimeError(f"optimal v1 plan failed: rc={rc}")
    values, nbits = v1_plan_fields(arr, sizes[: n_tokens.value], fidx,
                                   window=window, literal=literal)
    head = build_header(window, literal, dictionary is not None, False, False)
    return pack_bits_np(
        np.concatenate([np.array([v for v, _ in head], np.uint32), values]),
        np.concatenate([np.array([b for _, b in head], np.uint8), nbits]))[0]


def host_ext_prep(data, window: int):
    """(plans (k, 2) int64, khat uint32[n + 1], dh uint8, rc uint8) of one
    shard in one pass: the run plan, the model write counts, the model
    stream and the chunk counts at the chunks' model starts; the arrays of
    engine/plan.ext_prep, its plain version (``tpt_ext_prep``).  Releases
    the GIL, so shards run in parallel threads."""
    if not 8 <= window <= 15:
        raise ValueError(f"window must lie in [8, 15], not {window}")
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    n = arr.shape[0]
    plans = np.zeros((n // 9 + 2, 2), np.int64)
    khat = np.zeros(n + 1, np.uint32)
    dh = np.zeros(max(n, 1), np.uint8)
    rc = np.zeros(max(n, 1), np.uint8)
    n_plans = ctypes.c_int64(0)
    dh_len = ctypes.c_int64(0)
    code = _host_entry("tpt_ext_prep")(
        _ptr(arr), n, window, _ptr(plans), plans.shape[0],
        ctypes.addressof(n_plans), _ptr(khat), _ptr(dh), _ptr(rc),
        ctypes.addressof(dh_len))
    if code != 0:
        raise ValueError(f"ext prep failed: rc={code}")
    k = dh_len.value
    return plans[: n_plans.value], khat, dh[:k], rc[:k]


def host_ext_tail_bits(data, t_in: int, dh, khat, plans, *, window: int,
                       literal: int, acc: int, an: int, lazy: bool = False,
                       dictionary=None) -> bytes:
    """The tail bytes of a planned extended stream from input position
    ``t_in`` (a walk entry where the card's commit stopped): the kernel's
    bit remainder ``(acc, an)`` then the planned walk's tokens over the
    rest, the last partial byte zero-padded (``tpt_ext_tail_bits``;
    engine/tail.ext_tail_bits is its plain version).  ``dh``, ``khat``,
    ``plans``: :func:`host_ext_prep`'s; the walk replays the model
    stream's last window into the ring and searches it, so it needs no
    table row.  ``dictionary``: the initial window (bytes or uint8 array),
    else the default at ``literal``.  ExcessBitsError for a byte wider than
    ``literal`` bits."""
    compute_min_pattern_size(window, literal)  # validates the config
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    n = arr.shape[0]
    kh = np.ascontiguousarray(khat, np.uint32)
    if kh.shape != (n + 1,):
        raise ValueError("khat must hold n + 1 write counts")
    if not 0 <= t_in <= n:
        raise ValueError("t_in must lie in [0, n]")
    d = np.ascontiguousarray(dh, np.uint8)
    if d.shape != (int(kh[n]),):
        raise ValueError("dh must hold khat[n] model bytes")
    pl = np.ascontiguousarray(plans, np.int64).reshape(-1)
    if pl.shape[0] % 2 or (pl.size and (pl.min() < 0 or pl.max() > n or (
            np.diff(pl) < 0).any())):
        raise ValueError("plans must hold sorted (rle_start, end) pairs "
                         "inside the input")
    n_plan = pl.shape[0] // 2
    if n_plan == 0:
        pl = np.zeros(2, np.int64)  # a plan pointer holding no pairs
    dict_arr = window_array(window, literal, dictionary)
    cap = (n - t_in) * 2 + 64
    out = np.zeros(cap, np.uint8)
    out_len = ctypes.c_int64(0)
    code = _host_entry("tpt_ext_tail_bits")(
        _ptr(arr), n, t_in, _ptr(d), _ptr(kh), _ptr(pl), n_plan,
        _ptr(dict_arr), window, literal, int(lazy), acc, an, _ptr(out), cap,
        ctypes.addressof(out_len))
    if code == -2:
        raise ExcessBitsError
    if code != 0:
        raise ValueError(f"ext tail walk failed: rc={code}")
    return out[: out_len.value].tobytes()

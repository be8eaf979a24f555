"""Tamp stream header, v1 window model, bit packing, the optimal encodes'
host helpers, and the JAX module's one-stream encodes on the card.

``build_header``, ``model_history``, ``opt_ext_runs``, ``opt_ext_emit``
and ``v1_plan_fields`` are copies of the JAX package's ``engine.encode``,
``pack_bits_np`` of its ``ops.bitpack``; :func:`bits_to_bytes` finishes a
stream behind a commit kernel's bit remainder.  :func:`encode_v1` and
:func:`encode_extended_optimal` are that module's encodes under its names
and signatures, one shard of the card's batch encodes
(engine/pipeline.py, engine/pipeline_ext.py)."""

from __future__ import annotations

import numpy as np

from ..constants import (
    HUFFMAN_CODES, HUFFMAN_LENGTHS, RLE_MAX_WINDOW_WRITE,
    compute_min_pattern_size,
)
from ..dictionary import dictionary_array
from ..exceptions import ExcessBitsError

__all__ = ["build_header", "model_history", "bits_to_bytes", "pack_bits_np",
           "opt_ext_runs", "opt_ext_emit", "v1_plan_fields", "encode_v1",
           "encode_extended_optimal"]


def build_header(
    window: int, literal: int, custom_dictionary: bool, extended: bool,
    dictionary_reset: bool,
) -> list[tuple[int, int]]:
    """Header byte(s) as (value, nbits) fields."""
    header = (
        ((window - 8) << 5)
        | ((literal - 5) << 3)
        | ((1 if custom_dictionary else 0) << 2)
        | ((1 if extended else 0) << 1)
        | (1 if dictionary_reset else 0)
    )
    fields = [(header, 8)]
    if dictionary_reset:
        fields.append((0, 8))  # header byte 2, reserved
    return fields


def model_history(data: np.ndarray, window: int, literal: int,
                  extended: bool, dictionary):
    """``(initial window, C = initial window || data)``: the v1
    window-write history model."""
    if dictionary is not None:
        dict_arr = np.frombuffer(bytes(dictionary), dtype=np.uint8)
        if dict_arr.shape[0] != (1 << window):
            raise ValueError("Dictionary-window size mismatch.")
    else:
        # v1 compatibility quirk: non-extended streams always seed with
        # literal=8 (spec: specification.rst "Dictionary Initialization").
        dict_arr = dictionary_array(1 << window,
                                    literal=literal if extended else 8)
    return dict_arr, np.concatenate([dict_arr, data])


def bits_to_bytes(fields, acc: int, an: int) -> bytes:
    """Push ``(value, nbits)`` fields behind the ``an``-bit remainder
    ``acc``, MSB-first, and zero-pad the final partial byte."""
    out = bytearray()
    for v, nb in list(fields) + [(0, 0)]:  # the empty field drains acc
        acc = (acc << nb) | v
        an += nb
        while an >= 8:
            out.append((acc >> (an - 8)) & 0xFF)
            an -= 8
            acc &= (1 << an) - 1
    if an:
        out.append((acc << (8 - an)) & 0xFF)
    return bytes(out)


def pack_bits_np(values: np.ndarray, nbits: np.ndarray) -> tuple[bytes, int]:
    """Pack ``(values, nbits)`` fields MSB-first; returns (bytes,
    total_bits), the last byte zero-padded.  ``values`` must already be
    masked to ``nbits`` bits (at most 33).  Each field is left-aligned in
    a 64-bit lane at its byte offset and the eight byte lanes are summed
    with ``np.bincount``: the bits are disjoint, so the sum is an OR."""
    values = np.asarray(values, dtype=np.uint64)
    nbits64 = np.asarray(nbits, dtype=np.int64)
    if values.size == 0:
        return b"", 0
    offsets = np.concatenate(([0], np.cumsum(nbits64)))
    total_bits = int(offsets[-1])
    offsets = offsets[:-1]
    nbytes = (total_bits + 7) // 8
    start_byte = offsets >> 3
    lead = (offsets & 7).astype(np.uint64)
    chunk = values << (np.uint64(64) - lead - nbits64.astype(np.uint64))
    out = np.zeros(nbytes + 8, dtype=np.float64)
    for k in range(8):
        lane = ((chunk >> np.uint64(56 - 8 * k))
                & np.uint64(0xFF)).astype(np.float64)
        out[: nbytes + 8] += np.bincount(start_byte + k, weights=lane,
                                         minlength=nbytes + 8)
    packed = out[:nbytes].astype(np.uint64).astype(np.uint8)
    return packed.tobytes(), total_bits


def v1_plan_fields(data: np.ndarray, sizes: np.ndarray, fidx: np.ndarray, *,
                   window: int, literal: int):
    """(values uint32, nbits uint8) fields of a v1 token plan: ``sizes``
    per token (1 a literal), a match at the table's ring slot ``fidx`` of
    its first position (any prefix of the longest match is a match at the
    same slot).  ExcessBitsError for a literal wider than ``literal``
    bits.  A copy of the JAX module's ``_emit_v1_plan``."""
    minp = compute_min_pattern_size(window, literal)
    T = sizes.shape[0]
    starts = np.zeros(T, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:] if T else starts[:0])
    lit = sizes == 1
    lit_limit = 256 if literal == 8 else (1 << literal)
    dstart = data[starts] if T else np.zeros(0, np.uint8)
    if np.any(lit & (dstart >= lit_limit)):
        raise ExcessBitsError
    sym = np.clip(sizes.astype(np.int32) - minp, 0, 13)
    HC = np.asarray(HUFFMAN_CODES[:14], np.uint32)
    HL = np.asarray(HUFFMAN_LENGTHS[:14], np.uint32)
    idx = fidx[starts].astype(np.uint32) if T else np.zeros(0, np.uint32)
    values = np.where(lit, (1 << literal) | dstart.astype(np.uint32),
                      (HC[sym] << window) | idx).astype(np.uint32)
    nbits = np.where(lit, literal + 1, HL[sym] + window).astype(np.uint8)
    return values, nbits


def opt_ext_runs(data: np.ndarray, window: int):
    """Forced-RLE regions of the optimal extended parse: ``(runs, khat,
    chunks)``.

    Regions cover byte runs of 13 or more (the run's first byte stays in
    the DP, so the decoder's previous window byte is the run byte).
    ``runs``: (a, b) region pairs in input coordinates; ``khat``: (n + 1,)
    uint32 write counts modelling each chunk's window write of at most
    ``RLE_MAX_WINDOW_WRITE`` bytes without wrap (None without a region);
    ``chunks``: (start, count) per RLE chunk in walk order (241, or 240
    before a rest of 2)."""
    n = data.shape[0]
    W = 1 << window
    RUN_MIN = 13
    runs, chunks = [], []
    khat = None
    if n:
        starts_r = np.flatnonzero(
            np.concatenate(([True], data[1:] != data[:-1])))
        lens_r = np.diff(np.append(starts_r, n))
        long_mask = lens_r >= RUN_MIN
        if np.any(long_mask):
            inc = np.ones(n, np.int64)
            cum_full = np.cumsum(inc)  # writes before, with no skips
            skipped = 0
            for rs, ln in zip(starts_r[long_mask], lens_r[long_mask]):
                a, b = int(rs) + 1, int(rs + ln)
                runs.append((a, b))
                pos = int((cum_full[a - 1] - skipped) % W)
                i = a
                while i < b:
                    rest = b - i
                    count = (241 if rest >= 243
                             else (240 if rest == 242 else rest))
                    chunks.append((i, count))
                    wr = min(count, RLE_MAX_WINDOW_WRITE, W - pos)
                    inc[i + wr : i + count] = 0
                    skipped += count - wr
                    pos = (pos + wr) % W
                    i += count
            khat = np.zeros(n + 1, np.uint32)
            np.cumsum(inc, out=khat[1:])
    return runs, khat, chunks


def opt_ext_emit(data: np.ndarray, sizes, kinds, fidx, *, window: int,
                 literal: int, custom_dict: bool) -> bytes:
    """One extended-format stream, header included, of a token plan:
    ``sizes``/``kinds`` per token (kinds 0 literal, 1 basic, 2 extended,
    3 RLE), ``fidx`` the per-position ring slots.  Raises ExcessBitsError
    for a literal wider than ``literal`` bits."""
    minp = compute_min_pattern_size(window, literal)
    T = sizes.shape[0]
    starts = np.zeros(T, np.int64)
    if T:
        np.cumsum(sizes[:-1], out=starts[1:])
    lit = kinds == 0
    ext = kinds == 2
    rle = kinds == 3
    lit_limit = 256 if literal == 8 else (1 << literal)
    dstart = data[starts] if T else np.zeros(0, np.uint8)
    if np.any(lit & (dstart >= lit_limit)):
        raise ExcessBitsError
    HC = np.asarray(HUFFMAN_CODES, np.uint32)
    HL = np.asarray(HUFFMAN_LENGTHS, np.uint32)
    idx = fidx[starts].astype(np.uint32) if T else np.zeros(0, np.uint32)
    sym_b = np.clip(sizes.astype(np.int32) - minp, 0, 13)
    v_ext = np.clip(sizes.astype(np.int32) - minp - 12, 0, 119)
    sym2e = v_ext >> 3
    traile = (v_ext & 7).astype(np.uint32)
    v_rle = np.clip(sizes.astype(np.int32) - 2, 0, 239)  # count - 2
    sym2r = v_rle >> 4
    trailr = (v_rle & 15).astype(np.uint32)

    f1val = np.select(
        [lit, ext, rle],
        [(1 << literal) | dstart.astype(np.uint32),
         (HC[13] << (HL[sym2e] - 1)) | HC[sym2e],
         (HC[12] << (HL[sym2r] - 1)) | HC[sym2r]],
        default=(HC[sym_b] << window) | idx).astype(np.uint32)
    f1bits = np.select(
        [lit, ext, rle],
        [np.full(T, literal + 1, np.uint32),
         HUFFMAN_LENGTHS[13] + HL[sym2e] - 1,
         HUFFMAN_LENGTHS[12] + HL[sym2r] - 1],
        default=HL[sym_b] + window).astype(np.uint8)
    # second field: the extended match's trail and index, or the RLE trail
    has_f2 = ext | rle
    f2val = np.where(ext, (traile << window) | idx, trailr).astype(np.uint32)
    f2bits = np.where(ext, 3 + window, 4).astype(np.uint8)

    n_f2 = int(has_f2.sum())
    pos = np.arange(T, dtype=np.int64)
    if T:
        pos += np.concatenate([[0],
                               np.cumsum(has_f2.astype(np.int64))[:-1]])
    values = np.zeros(T + n_f2, np.uint32)
    nbits = np.zeros(T + n_f2, np.uint8)
    values[pos] = f1val
    nbits[pos] = f1bits
    values[pos[has_f2] + 1] = f2val[has_f2]
    nbits[pos[has_f2] + 1] = f2bits[has_f2]

    head = build_header(window, literal, custom_dict, True, False)
    all_values = np.concatenate(
        [np.array([v for v, _ in head], np.uint32), values])
    all_nbits = np.concatenate(
        [np.array([nb for _, nb in head], np.uint8), nbits])
    packed, _ = pack_bits_np(all_values, all_nbits)
    return packed


def encode_v1(data, *, window: int = 10, literal: int = 8,
              lazy_matching: bool = False, dictionary=None, search_fn=None,
              parse: str = "greedy", device=None) -> bytes:
    """One v1 Tamp stream of ``data`` on the card, byte-equal to the JAX
    package's ``engine.encode_v1``: ``parse="greedy"``, one shard of
    ``engine/pipeline.encode_v1_device_commit`` (the reference greedy
    encoder's stream; kernels B5 and B3, or B5 with the probe and B6 under
    ``lazy_matching``); ``parse="optimal"``, one shard of
    ``encode_v1_device_optimal`` (B5, X3 and B3; ``lazy_matching`` does
    not apply).  ValueError for another ``parse``, and for a
    ``search_fn``: the JAX module's table backend hook, whose tables here
    are kernel B5's.  ``device``: None for the CUDA card, ``"cpu"`` for
    the plain versions."""
    from .pipeline import encode_v1_device_commit, encode_v1_device_optimal

    if search_fn is not None:
        raise ValueError("search_fn is not supported: the tables are "
                         "kernel B5's")
    if parse == "optimal":
        return encode_v1_device_optimal(
            [data], window=window, literal=literal, dictionary=dictionary,
            device=device)[0]
    if parse != "greedy":
        raise ValueError(f"unknown parse strategy: {parse!r}")
    return encode_v1_device_commit(
        [data], window=window, literal=literal, lazy_matching=lazy_matching,
        dictionary=dictionary, device=device)[0]


def encode_extended_optimal(data, *, window: int = 10, literal: int = 8,
                            dictionary=None, device=None) -> bytes:
    """One extended-format stream of the minimum-bit parse, byte-equal to
    the JAX package's ``engine.encode_extended_optimal``: one shard of
    ``engine/pipeline_ext.encode_ext_device_optimal`` (the host tables and
    walk, kernel X4's DP).  ``device``: as :func:`encode_v1`."""
    from .pipeline_ext import encode_ext_device_optimal

    return encode_ext_device_optimal(
        [data], window=window, literal=literal, dictionary=dictionary,
        device=device)[0]

"""v1-format encode on the card.

Counterpart of ``tamp_tpu/engine/pipeline.encode_v1_device_commit`` (its
fused branch, ops/encode_fused.py) and ``_pull_body_bytes``:

  1. device, one call per batch: kernel B5's tables, the pack, and the
     commit walk (the v1 field planner and kernel B3, or under lazy
     matching kernel B6), which stops at the first token start
     >= npos - 15;
  2. host: the last < 16 bytes of each shard, with the reference's
     shrinking ring search and lazy cache (the 16-byte table cap cannot
     reproduce its tie-breaks there), stitched behind the kernel's bit
     remainder (up to 31 bits from B3, fewer than 8 from B6) and its lazy
     cache.

Output is byte-identical to the JAX package's device-commit v1 encode and
to the native encoder (``extended=False``).

:func:`encode_v1_device_optimal` is the counterpart of the JAX module's
``encode_v1_device_optimal`` and its stage ``_opt_v1_stage_impl``: the
minimum-bit parse on the card (:func:`v1_optimal_stage`: kernel B5's tables
at cap ``min(16, minp + 13)``, kernel X3's DP, the fields of the chosen
tokens, kernel B3 walking to the end of each shard), and on the host only
the header and the bit remainder.  Streams are byte-identical to the JAX
package's ``encode_v1(parse="optimal")``.

:func:`encode_device_batch` is ``engine="device"``, the counterpart of the
JAX module's ``device_search_fn`` and ``encode_device`` as
``compress_sharded`` runs them, one shard a call, on a thread pool.
Extended (engine/encode_extended.py): one call of kernel B5
(:func:`device_tables`) per batch of shards, the table planes to the host
in one pull (:func:`card_tables`), then the host table committer
(engine/greedy.table_compress) on one thread a shard.  v1: the card's own
v1 encode (:func:`encode_v1_device_commit`), whose streams are the ones
the JAX package's table committer writes (both the reference greedy
encoder's).  :func:`encode_device` is the one-shot form, a batch of one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import trace
from ..constants import (
    HUFFMAN_CODES, HUFFMAN_LENGTHS, compute_min_pattern_size,
)
from ..device import resolve_device
from ..exceptions import ExcessBitsError
from ..ops.encode_commit import (
    S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NBYTES, S_T, TILE,
)
from ..ops.encode_commit import commit_fields
from ..ops.encode_fused import encode_v1_fused, v1_cap
from ..ops.match_v1 import v1_tables
from ..ops.opt_parse import opt_v1_choice
from .commit import ring_find_longest, ring_model_snapshot
from .encode import bits_to_bytes, build_header, model_history

__all__ = ["encode_v1_device_commit", "encode_v1_device_optimal",
           "v1_optimal_stage", "optimal_fields_v1", "optimal_streams_v1",
           "finish_streams",
           "pad_shards", "pull_body_bytes", "per_shard", "device_tables",
           "pack_tables", "unpack_tables", "card_tables",
           "encode_device_batch", "encode_device",
           "device_pipeline_available"]


def pull_body_bytes(out: torch.Tensor, state: np.ndarray):
    """Copy only the compressed bytes to the host: one slice of ``out``
    (S, max_out) bounded by the batch's longest body.  Returns a list of
    per-shard uint8 arrays of exact length."""
    nbs = [int(r[S_NBYTES]) for r in state]
    blk = out[:, : max([1] + nbs)].cpu().numpy()
    trace.count("encode.pull_bytes", blk.nbytes)
    return [blk[i, :nb] for i, nb in enumerate(nbs)]


def _tail_fields(data, C, t: int, cached, *, window: int, literal: int,
                 lazy: bool):
    """Token fields of the reference walk from input position ``t`` to the
    end of ``data`` (fewer than 16 bytes), on a ring materialized from the
    model history ``C``; ``cached``: the walk's lazy cache or None."""
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    maxpat = minp + 13
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    N = data.shape[0]
    fields: list[tuple[int, int]] = []
    ring = ring_model_snapshot(C, t, window)
    tau_ring = t % W

    def literal_at(b: int) -> None:
        nonlocal tau_ring
        if b >= lit_limit:
            raise ExcessBitsError
        fields.append((lit_flag | b, literal + 1))
        ring[tau_ring] = b
        tau_ring = (tau_ring + 1) % W

    while t < N:
        rem = N - t
        if lazy and cached is not None:
            idx, size = cached
            cached = None
        else:
            idx, size = ring_find_longest(ring, data[t : t + rem], minp,
                                          min(rem, maxpat))
        pending = rem if rem < 16 else 16
        if lazy and minp <= size <= 8 and pending > size + 2:
            pix, psize = ring_find_longest(ring, data[t + 1 : t + rem], minp,
                                           min(rem - 1, maxpat))
            tau = t % W
            if psize > size and not pix <= tau < pix + psize:
                literal_at(int(data[t]))
                cached = (pix, psize)
                t += 1
                continue
        if size >= minp:
            sym = size - minp
            fields.append(((HUFFMAN_CODES[sym] << window) | idx,
                           HUFFMAN_LENGTHS[sym] + window))
            for k in range(size):
                ring[tau_ring] = data[t + k]
                tau_ring = (tau_ring + 1) % W
            t += size
        else:
            literal_at(int(data[t]))
            t += 1
    return fields


def pad_shards(datas):
    """(batch, npos): the raw shards zero-padded into one (S, NP) uint8
    array, NP a power of two >= TILE, and their (S,) int32 lengths."""
    maxN = max(d.shape[0] for d in datas)
    NP = 1 << (max(maxN, TILE, 1) - 1).bit_length()
    batch = np.zeros((len(datas), NP), np.uint8)
    for i, d in enumerate(datas):
        batch[i, : d.shape[0]] = d
    return batch, np.asarray([d.shape[0] for d in datas], np.int32)


def encode_v1_device_commit(shards, *, window: int = 10, literal: int = 8,
                            lazy_matching: bool = False,
                            dictionary: bytes | None = None,
                            device=None) -> list[bytes]:
    """v1-format encode of a batch of shards; one Tamp stream each.

    ``dictionary``: a full-window custom dictionary, else the v1 default
    (``dictionary_array(W, literal=8)`` at every literal width).
    ``device``: None for the CUDA card; ``"cpu"`` runs the plain versions.
    """
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    with trace.span("tamp.encode.prep"):
        datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
        if not datas:
            return []
        with trace.span("tamp.encode.history"):
            histories = [model_history(d, window, literal, False,
                                       dictionary)[1] for d in datas]
            dict_arr = histories[0][: 1 << window]
        batch, npos = pad_shards(datas)
    NP = batch.shape[1]
    with trace.span("tamp.encode.h2d"):
        batch_d = torch.from_numpy(batch).to(dev)
        npos_d = torch.from_numpy(npos).to(dev)
        dict_d = torch.from_numpy(dict_arr.copy()).to(dev)
        trace.count("encode.h2d_bytes",
                    batch.nbytes + npos.nbytes + dict_arr.nbytes)
    with trace.span("tamp.encode.device", device=dev):
        out, state = encode_v1_fused(
            batch_d, npos_d, dict_d, window=window, literal=literal,
            lazy=lazy_matching, max_out=NP + NP // 8 + 64)
        # the inputs' device memory goes back before the pull
        del batch_d, npos_d, dict_d
    with trace.span("tamp.encode.pull"):
        state = state.cpu().numpy()
        trace.count("encode.pull_bytes", state.nbytes)
        if (state[:, S_ERR] != 0).any():
            raise ExcessBitsError
        bodies = pull_body_bytes(out, state)
    with trace.span("tamp.encode.tail"):
        return finish_streams(datas, histories, state, bodies,
                              window=window, literal=literal,
                              lazy_matching=lazy_matching,
                              custom=dictionary is not None)


def finish_streams(datas, histories, state: np.ndarray, bodies, *,
                   window: int, literal: int, lazy_matching: bool,
                   custom: bool) -> list[bytes]:
    """The host ring tail: each shard's stream from its header, the
    kernel's body bytes and the fields of its last < 16 bytes stitched
    behind the kernel's bit remainder (``state``: the commit's state rows
    on the host; ``histories``: the model histories)."""
    (hv, _hn), = build_header(window, literal, custom, False, False)
    results: list[bytes] = []
    for i, data in enumerate(datas):
        st = state[i]
        t = int(st[S_T])
        fields = []
        if t < data.shape[0]:
            cached = None
            if lazy_matching and int(st[S_CIDX]) >= 0:
                cached = (int(st[S_CIDX]), int(st[S_CSZ]))
            fields = _tail_fields(data, histories[i], t, cached,
                                  window=window, literal=literal,
                                  lazy=lazy_matching)
        tail = bits_to_bytes(fields, int(st[S_ACC]), int(st[S_AN]))
        results.append(bytes([hv]) + bodies[i].tobytes() + tail)
    return results


def optimal_fields_v1(choice: torch.Tensor, fidx: torch.Tensor,
                      data: torch.Tensor, npos: torch.Tensor, *, window: int,
                      literal: int):
    """(A, B) fields of the optimal v1 tokens at every position: a match of
    size ``choice`` (huffman(size - minp), then its ring slot ``fidx``) or
    a literal, two consecutive literals fused into one field of advance 2
    unless the second lies past the shard (padding positions are free
    literals, not tokens).  B = ``nb | adv << 6 | err << 14``, err an
    in-shard literal wider than ``literal`` bits."""
    minp = compute_min_pattern_size(window, literal)
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    nbl = literal + 1
    NP = choice.shape[1]
    di = data.to(torch.int32)
    in_shard = (torch.arange(NP, device=choice.device)[None, :]
                < npos.to(torch.int64)[:, None])
    is_lit = choice == 1
    sym = torch.clamp(choice - minp, 0, 13)
    hsel = torch.tensor(
        [(HUFFMAN_CODES[sy] << window) | ((HUFFMAN_LENGTHS[sy] + window) << 25)
         for sy in range(14)], dtype=torch.int32, device=choice.device)[
        sym.long()]
    A = torch.where(is_lit, lit_flag | di, (hsel & 0x1FFFFFF) | fidx)
    nb = torch.where(is_lit, nbl, (hsel >> 25) & 31)
    err = is_lit & (di >= lit_limit) & in_shard
    adv = choice
    nxt_lit = torch.roll(is_lit, -1, 1)
    nxt_lit[:, -1] = False
    nxt_in = torch.roll(in_shard, -1, 1)
    nxt_in[:, -1] = False
    pair = is_lit & nxt_lit & nxt_in
    A = torch.where(pair, (A << nbl) | torch.roll(A, -1, 1), A)
    nb = torch.where(pair, 2 * nbl, nb)
    adv = torch.where(pair, 2, adv)
    err = torch.where(pair, err | torch.roll(err, -1, 1), err)
    return A, (nb | (adv << 6) | (err.to(torch.int32) << 14)).to(torch.int32)


def v1_optimal_stage(data: torch.Tensor, npos: torch.Tensor,
                     dict_arr: torch.Tensor, *, window: int, literal: int,
                     max_out: int):
    """The optimal v1 encode's device half for one batch: (bytes (S,
    max_out) uint8, state (S, 16) int32, bad (S,) bool).

    Kernel B5's tables, kernel X3's choice (``bad`` where a shard has an
    in-shard position with no valid token, as the native DP raises there
    even if its walk never visits it), the fields, and kernel B3 on
    ``npos + 15``: the optimal fields are exact at every position, so the
    walk runs to the end of each shard."""
    flen, fidx = v1_tables(data, npos, dict_arr, window_bits=window,
                           cap=v1_cap(window, literal))
    choice, _cost0, bad = opt_v1_choice(flen, data, npos, window=window,
                                        literal=literal)
    A, B = optimal_fields_v1(choice, fidx, data, npos, window=window,
                             literal=literal)
    out, state = commit_fields(A, B, npos + 15, max_out=max_out)
    return out, state, bad


def encode_v1_device_optimal(shards, *, window: int = 10, literal: int = 8,
                             dictionary: bytes | None = None,
                             device=None) -> list[bytes]:
    """Optimal (minimum-bit) v1 encode of a batch of shards, one Tamp
    stream each, byte-identical to the JAX package's
    ``encode_v1(parse="optimal")``.

    The whole batch is one device stage (:func:`v1_optimal_stage`); the
    JAX package splits batches of four or more shards in two for the TPU's
    memory, which the streams do not depend on.  ``dictionary``: a
    full-window custom dictionary, else the v1 default.  ``device``: None
    for the CUDA card; ``"cpu"`` runs the plain versions.  Raises
    ExcessBitsError where a byte fits neither a literal nor a match."""
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
    if not datas:
        return []
    dict_arr, _ = model_history(datas[0][:0], window, literal, False,
                                dictionary)
    batch, npos = pad_shards(datas)
    NP = batch.shape[1]
    out, state, bad = v1_optimal_stage(
        torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
        torch.from_numpy(dict_arr.copy()).to(dev), window=window,
        literal=literal, max_out=NP + NP // 8 + 64)
    state = state.cpu().numpy()
    if (state[:, S_ERR] != 0).any() or bool(bad.any()):
        raise ExcessBitsError
    return optimal_streams_v1(pull_body_bytes(out, state), state,
                              window=window, literal=literal,
                              custom=dictionary is not None)


def optimal_streams_v1(bodies, state: np.ndarray, *, window: int,
                       literal: int, custom: bool) -> list[bytes]:
    """Each shard's optimal v1 stream: the header, the commit's body bytes
    and its bit remainder (up to 31 bits, ``state`` on the host)."""
    (hv, _hn), = build_header(window, literal, custom, False, False)
    return [bytes([hv]) + body.tobytes()
            + bits_to_bytes((), int(st[S_ACC]), int(st[S_AN]))
            for body, st in zip(bodies, state)]


def per_shard(fn, n: int, workers: int | None = None) -> list:
    """``[fn(i) for i in range(n)]``, one thread per shard, at most
    ``workers`` at a time (default: the CPU count); the host committer,
    table search and choice walk release the GIL."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    fn = trace.bind(fn)
    with ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 4) as ex:
        return list(ex.map(fn, range(n)))


def device_tables(rows: torch.Tensor, npos: torch.Tensor,
                  dict_arr: torch.Tensor, *, window: int, lazy: bool):
    """Kernel B5's tables of the extended ``engine="device"`` (the JAX
    module's ``device_search_fn``): ``rows`` (S, NP) uint8 against
    ``dict_arr`` at cap 16, and with ``lazy`` the probe family.  Returns
    (flen, fidx[, plen, pidx]), (S, NP) int32."""
    return v1_tables(rows, npos, dict_arr, window_bits=window, cap=16,
                     probe=lazy)


def pack_tables(tabs, window: int) -> torch.Tensor:
    """The tables packed for one pull: each family as ``len | idx << 5``
    (int16 at window <= 10, int32 above), stacked into one (F, S, NP)
    tensor on the tables' device."""
    dt = torch.int16 if window <= 10 else torch.int32
    return torch.stack([(tabs[k] | (tabs[k + 1] << 5)).to(dt)
                        for k in range(0, len(tabs), 2)])


def unpack_tables(planes: np.ndarray) -> tuple:
    """A shard's committer tables from its (F, n) rows of
    :func:`pack_tables`' planes: (flen uint8, fidx int32[, plen, pidx])."""
    out = []
    for p in planes:
        out += [(p & 31).astype(np.uint8), (p >> 5).astype(np.int32)]
    return tuple(out)


def card_tables(rows, dict_arr: np.ndarray, dev, *, window: int,
                lazy: bool) -> np.ndarray:
    """One batch on the card: ``rows`` (uint8 arrays) padded by
    :func:`pad_shards`, kernel B5 (:func:`device_tables`) in one launch,
    and its packed planes (:func:`pack_tables`) pulled in one copy."""
    batch, npos = pad_shards(rows)
    tabs = device_tables(
        torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
        torch.from_numpy(np.array(dict_arr)).to(dev), window=window,
        lazy=lazy)
    return pack_tables(tabs, window).cpu().numpy()


def encode_device_batch(shards, *, window: int = 10, literal: int = 8,
                        extended: bool = True, lazy_matching: bool = False,
                        dictionary: bytes | None = None, device=None,
                        workers: int | None = None) -> list[bytes]:
    """``engine="device"`` on a batch of shards, one Tamp stream each.

    Extended (engine/encode_extended.py): kernel B5 once for the batch on
    the model histories, then the host table committer on one thread a
    shard (``workers`` at a time, default the CPU count); streams
    byte-identical to the JAX package's ``encode_extended``.  v1:
    :func:`encode_v1_device_commit` (B5 once for the batch, then the
    card's commit kernel); the JAX package's table committer writes the
    same stream there, the reference greedy encoder's (``encode_v1``).
    ``dictionary``: a full-window custom dictionary, else the format's
    default (v1: literal 8).  ``device``: None for the CUDA card;
    ``"cpu"`` runs the plain versions.  Nothing falls back to a host
    search: without a card ``device=None`` raises."""
    if not extended:
        return encode_v1_device_commit(
            shards, window=window, literal=literal,
            lazy_matching=lazy_matching, dictionary=dictionary,
            device=device)
    from .encode_extended import encode_extended_batch

    return encode_extended_batch(
        [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards],
        window=window, literal=literal, lazy_matching=lazy_matching,
        dictionary=dictionary, device=device, workers=workers)


def encode_device(data, *, window: int = 10, literal: int = 8,
                  extended: bool = True, lazy_matching: bool = False,
                  dictionary=None, device=None) -> bytes:
    """One Tamp stream of ``engine="device"`` (the JAX module's
    ``encode_device``): :func:`encode_device_batch` on a batch of one."""
    return encode_device_batch(
        [data], window=window, literal=literal, extended=extended,
        lazy_matching=lazy_matching, dictionary=dictionary,
        device=device)[0]


def device_pipeline_available() -> bool:
    """Whether the device encodes can run: a CUDA card is visible."""
    return torch.cuda.is_available()

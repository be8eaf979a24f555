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
to the native encoder (``extended=False``).  The optimal v1 encode and the
``engine="device"`` one-shot functions of the JAX module are not ported
(ROADMAP.md queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    HUFFMAN_CODES, HUFFMAN_LENGTHS, compute_min_pattern_size,
)
from ..device import resolve_device
from ..exceptions import ExcessBitsError
from ..ops.encode_commit import (
    S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NBYTES, S_T, TILE,
)
from ..ops.encode_fused import encode_v1_fused
from .commit import ring_find_longest, ring_model_snapshot
from .encode import bits_to_bytes, build_header, model_history

__all__ = ["encode_v1_device_commit", "finish_streams", "pad_shards",
           "pull_body_bytes"]


def pull_body_bytes(out: torch.Tensor, state: np.ndarray):
    """Copy only the compressed bytes to the host: one slice of ``out``
    (S, max_out) bounded by the batch's longest body.  Returns a list of
    per-shard uint8 arrays of exact length."""
    nbs = [int(r[S_NBYTES]) for r in state]
    blk = out[:, : max([1] + nbs)].cpu().numpy()
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
    datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
    S = len(datas)
    if S == 0:
        return []
    histories = [model_history(d, window, literal, False, dictionary)[1]
                 for d in datas]
    dict_arr = histories[0][: 1 << window]
    batch, npos = pad_shards(datas)
    NP = batch.shape[1]

    out, state = encode_v1_fused(
        torch.from_numpy(batch).to(dev), torch.from_numpy(npos).to(dev),
        torch.from_numpy(dict_arr.copy()).to(dev), window=window,
        literal=literal, lazy=lazy_matching, max_out=NP + NP // 8 + 64)
    state = state.cpu().numpy()
    if (state[:, S_ERR] != 0).any():
        raise ExcessBitsError
    bodies = pull_body_bytes(out, state)
    return finish_streams(datas, histories, state, bodies, window=window,
                          literal=literal, lazy_matching=lazy_matching,
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

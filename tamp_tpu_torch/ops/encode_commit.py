"""Encode commit walks (kernels B3 and B6), their plain versions, and the
v1 field planner.

Counterparts in ``tamp_tpu/ops/encode_commit_pallas.py``:

- :func:`commit_fields` (B3): ``_commit_fields_batch`` (the
  ``_kernel_fields`` kernel, dual mode).  Per shard, a serial walk over
  planned fields (ops/plan_ext.py, or :func:`plan_fields_v1`): push each
  visited position's field into a bit accumulator, drain 32-bit words
  MSB-first (bytes big-endian), jump by the position's advance, stop at the
  first position >= npos - 15.
- :func:`plan_fields_v1`: ``plan_fields``, the non-lazy v1 fields in
  tensor ops, always in the dual (A, B) form.
- :func:`commit_v1_lazy` (B6): ``encode_commit_batch(lazy=True)`` (the
  ``_kernel`` kernel).  The lazy v1 greedy walk over packed tables, which
  decides the deferral in the walk and leaves its lazy cache in the state.

Each returns the byte rows (S, max_out) uint8 (zero past S_NBYTES) and the
state rows (S, 16) int32 in the JAX package's slot layout.  The CUDA
kernels are in ``csrc/encode_commit.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    HUFFMAN_CODES, HUFFMAN_LENGTHS, compute_min_pattern_size,
)
from . import _build

__all__ = ["commit_fields", "commit_fields_plain", "plan_fields_v1",
           "commit_v1_lazy", "commit_v1_lazy_plain", "S_T", "S_NBYTES",
           "S_ACC", "S_AN", "S_CIDX", "S_CSZ", "S_ERR", "S_NSLOTS",
           "ERR_EXCESS", "ERR_STALL", "TILE"]

TILE = 512  # the smallest padded model length the pipeline uses
LAZY_TILE = 4096  # positions per tile of B6's walk (FT, csrc/encode_commit.cu)
ERR_EXCESS = 1
ERR_STALL = 2  # a zero advance: malformed fields (the planner never makes one)
# state-row slots (per-shard output), as in the JAX package
S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NSLOTS = \
    0, 1, 2, 3, 4, 5, 6, 16


def _walk(a, b, npos: int, out: np.ndarray, idx_bits: int):
    """One shard's walk on Python ints; returns the state row values."""
    hard_stop = npos - 15
    t = err = an = nbytes = 0
    acc = 0
    mask64 = (1 << 64) - 1
    while t < hard_stop:
        m = b[t]
        fields = [(a[t] & 0xFFFFFFFF, m & 63)]
        if idx_bits and (m >> 15) & 1:  # split extended index, pushed second
            fields.append(((m >> 16) & 0x7FFF, idx_bits))
        for v, nb in fields:
            acc = ((acc << nb) | v) & mask64
            an += nb
            if an >= 32:
                w = (acc >> (an - 32)) & 0xFFFFFFFF
                if nbytes + 4 <= out.shape[0]:
                    out[nbytes : nbytes + 4] = (
                        w >> 24, (w >> 16) & 255, (w >> 8) & 255, w & 255)
                nbytes += 4
                an -= 32
        adv = (m >> 6) & 255
        if m & (1 << 14) or adv == 0:
            err = ERR_EXCESS if m & (1 << 14) else ERR_STALL
            t = npos
            break
        t += adv
    return t, nbytes, acc & ((1 << an) - 1), an, err


def commit_fields_plain(A: torch.Tensor, B: torch.Tensor, npos: torch.Tensor,
                        *, max_out: int, idx_bits: int = 0):
    """B3 as a Python loop per shard (on host copies of the inputs);
    results are returned on the inputs' device."""
    S = A.shape[0]
    a_h = A.cpu().numpy()
    b_h = B.cpu().numpy()
    n_h = npos.cpu().numpy()
    out = np.zeros((S, max_out), np.uint8)
    state = np.zeros((S, S_NSLOTS), np.int32)
    for s in range(S):
        n = int(n_h[s])
        lim = max(n - 15, 0)
        # the walk reads < hard_stop + 1 positions; a jump never needs more
        a = a_h[s, :lim].tolist()
        b = b_h[s, :lim].tolist()
        t, nbytes, acc, an, err = _walk(a, b, n, out[s], idx_bits)
        state[s, [S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR]] = (
            t, nbytes, acc, an, -1, 0, err)
    dev = A.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(state).to(dev)


def commit_fields(A: torch.Tensor, B: torch.Tensor, npos: torch.Tensor, *,
                  max_out: int, idx_bits: int = 0):
    """(bytes (S, max_out) uint8, state (S, 16) int32): kernel B3 for CUDA
    tensors, the plain version for CPU tensors."""
    if A.dtype != torch.int32 or B.dtype != torch.int32 or A.dim() != 2 \
            or A.shape != B.shape:
        raise ValueError("A and B must be (S, NP) int32 tensors")
    if npos.dtype != torch.int32 or npos.shape != (A.shape[0],):
        raise ValueError("npos must be an (S,) int32 tensor")
    if not (A.device == B.device == npos.device):
        raise ValueError("A, B and npos must share one device")
    if A.device.type == "cpu":
        return commit_fields_plain(A, B, npos, max_out=max_out,
                                   idx_bits=idx_bits)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    S, NP = A.shape
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=A.device)
    state = torch.empty((S, S_NSLOTS), dtype=torch.int32, device=A.device)
    _build.launch("encode_commit", "tpt_commit_fields", A.device,
                  (A.contiguous(), B.contiguous(), npos.contiguous(), out,
                   state), (S, NP, max_out, idx_bits))
    commit_fields.launches += 1
    return out, state


commit_fields.launches = 0


def plan_fields_v1(packed: torch.Tensor, *, window: int, literal: int):
    """(A, B) planned fields of the non-lazy v1 walk, elementwise.

    ``packed``: (S, NP) int32 ``len << 23 | idx << 8 | byte``.  For every
    position, the field the walk emits if it lands there: a match
    (huffman(len - minp) then the index, advance len) or a literal, where
    two consecutive literals fuse into one field (advance 2).  ``roll``
    wraps at the last column, as in the JAX package; the walk never reaches
    it.  A = value, B = ``nb | adv << 6 | err << 14``."""
    minp = compute_min_pattern_size(window, literal)
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    nbl = literal + 1
    byte = packed & 0xFF
    idx = (packed >> 8) & 0x7FFF
    size = packed >> 23
    is_match = size >= minp
    sym = torch.clamp(size - minp, 0, 13)
    hsel = torch.tensor(
        [(int(HUFFMAN_CODES[s]) << window)
         | ((int(HUFFMAN_LENGTHS[s]) + window) << 24) for s in range(14)],
        dtype=torch.int32, device=packed.device)[sym.long()]
    a_match = (hsel & 0xFFFFFF) | idx
    nb_match = hsel >> 24
    a_lit = lit_flag | byte
    err1 = ~is_match & (byte >= lit_limit)
    lit = ~is_match
    pair = lit & torch.roll(lit, -1, 1)
    a_next = torch.roll(a_lit, -1, 1)
    err2 = err1 | torch.roll(err1, -1, 1)
    A = torch.where(is_match, a_match,
                    torch.where(pair, (a_lit << nbl) | a_next, a_lit))
    nb = torch.where(is_match, nb_match, torch.where(pair, 2 * nbl, nbl))
    adv = torch.where(is_match, size, torch.where(pair, 2, 1))
    err = (~is_match & torch.where(pair, err2, err1)).to(torch.int32)
    return A, (nb | (adv << 6) | (err << 14)).to(torch.int32)


def _walk_lazy(p_row, q_row, npos: int, out: np.ndarray, *, window: int,
               literal: int):
    """One shard's lazy v1 walk on Python ints; returns the state row
    values (t, nbytes, acc, an, cidx, csz, err)."""
    W = 1 << window
    minp = compute_min_pattern_size(window, literal)
    lit_flag = 1 << literal
    lit_limit = 256 if literal == 8 else lit_flag
    t = nbytes = acc = an = err = csz = 0
    cidx = -1
    while t < npos - 15:
        p = p_row[t]
        byte, idx, size = p & 0xFF, (p >> 8) & 0x7FFF, p >> 23
        if cidx >= 0:  # the deferred match is taken first
            idx, size = cidx, csz
        cidx = -1
        q = q_row[t]
        pix, psz = q & 0x7FFF, q >> 15
        tau = t & (W - 1)
        # the probe applies to a cached size too: deferrals chain
        if minp <= size <= 8 and psz > size and not pix <= tau < pix + psz:
            cidx, csz = pix, psz
            size = 0  # a literal now
        if size >= minp:
            sym = min(size - minp, 13)
            v = (HUFFMAN_CODES[sym] << window) | idx
            nb = HUFFMAN_LENGTHS[sym] + window
        else:
            v, nb = lit_flag | byte, literal + 1
            if byte >= lit_limit:
                err = ERR_EXCESS
        acc = (acc << nb) | v
        an += nb
        while an >= 8:
            an -= 8
            if nbytes < out.shape[0]:
                out[nbytes] = (acc >> an) & 0xFF
            nbytes += 1
            acc &= (1 << an) - 1
        t = t + size if size >= minp else t + 1
        if err:
            t = npos
    return t, nbytes, acc, an, cidx, csz, err


def _check_lazy(packed, probe, npos):
    if packed.dtype != torch.int32 or probe.dtype != torch.int32 \
            or packed.dim() != 2 or packed.shape != probe.shape:
        raise ValueError("packed and probe must be (S, NP) int32 tensors")
    if npos.dtype != torch.int32 or npos.shape != (packed.shape[0],):
        raise ValueError("npos must be an (S,) int32 tensor")
    if not (packed.device == probe.device == npos.device):
        raise ValueError("packed, probe and npos must share one device")


def commit_v1_lazy_plain(packed: torch.Tensor, probe: torch.Tensor,
                         npos: torch.Tensor, *, window: int, literal: int,
                         max_out: int):
    """B6 as a Python loop per shard (on host copies of the inputs);
    results are returned on the inputs' device."""
    S = packed.shape[0]
    p_h = packed.cpu().numpy()
    q_h = probe.cpu().numpy()
    n_h = npos.cpu().numpy()
    out = np.zeros((S, max_out), np.uint8)
    state = np.zeros((S, S_NSLOTS), np.int32)
    for s in range(S):
        n = int(n_h[s])
        lim = max(n - 15, 0)
        state[s, : S_ERR + 1] = _walk_lazy(
            p_h[s, :lim].tolist(), q_h[s, :lim].tolist(), n, out[s],
            window=window, literal=literal)
    dev = packed.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(state).to(dev)


def commit_v1_lazy(packed: torch.Tensor, probe: torch.Tensor,
                   npos: torch.Tensor, *, window: int, literal: int,
                   max_out: int):
    """(bytes (S, max_out) uint8, state (S, 16) int32): kernel B6 for CUDA
    tensors, the plain version for CPU tensors.

    ``packed``: (S, NP) int32 ``len << 23 | idx << 8 | byte``; ``probe``:
    (S, NP) int32 ``plen << 15 | pidx``; ``npos``: (S,) int32."""
    _check_lazy(packed, probe, npos)
    if packed.device.type == "cpu":
        return commit_v1_lazy_plain(packed, probe, npos, window=window,
                                    literal=literal, max_out=max_out)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    S, NP = packed.shape
    dev = packed.device
    n_tiles = -(-NP // LAZY_TILE)
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
    state = torch.empty((S, S_NSLOTS), dtype=torch.int32, device=dev)
    # the kernel's workspace: every node's exit map, per tile its entry node
    # and lazy cache, its bit offset, per shard its bits and stop, and the
    # word row (zeroed: the tiles OR their words into it) with a tail slot
    ws = (torch.empty((S, 2 * NP), dtype=torch.int64, device=dev),
          torch.empty((S, n_tiles, 3), dtype=torch.int32, device=dev),
          torch.empty((S, n_tiles), dtype=torch.int64, device=dev),
          torch.empty((S, 4), dtype=torch.int64, device=dev),
          torch.zeros((S, -(-max_out // 4) + 1), dtype=torch.int32,
                      device=dev))
    _build.launch("encode_commit", "tpt_commit_v1_lazy", dev,
                  (packed.contiguous(), probe.contiguous(), npos.contiguous(),
                   out, state, *ws),
                  (S, NP, n_tiles, max_out, window, literal,
                   compute_min_pattern_size(window, literal)))
    commit_v1_lazy.launches += 1
    return out, state


commit_v1_lazy.launches = 0

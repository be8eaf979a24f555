"""Optimal (minimum-bit) extended parse on the card (kernel X4) and its
plain version.

Counterpart of ``tamp_tpu/ops/opt_parse_ext.py::opt_ext_choice_device``:
the three passes of ops/opt_parse.py (transfer matrices, combine, exact
costs and choice) with the full lookback K = maxpat = minp + 131.  Per
position the edges are the advance-1 slot and the contiguous advances
``minp .. hi``:

- the advance-1 slot costs a literal (``1 + literal`` bits, INF for a byte
  wider than ``literal`` bits, 0 past the shard) or, at a position inside
  a forced-RLE region (``interior``), the region's chunk-cost chain weight
  (the chunk's token bits at a chunk start, 0 elsewhere), so a region's
  start costs its RLE bits plus the cost at its end;
- a basic match of size s (minp <= s <= minp + 11) needs ``flen >= s`` and
  ``bound >= s`` (no token lands inside a region); an extended one (s >=
  minp + 12) also ``room >= s`` (no write past the ring end), so ``hi =
  min(flen, bound, room >= minp + 12 ? room : minp + 11)``; interior
  positions have no match edge.

The choice is the lowest advance among the minimal saturated costs (the
JAX function's ``argmin``: literal, basic sizes, extended sizes); ``bad``
marks a shard where some in-shard, non-interior position costs INF.  As in
X3, the combine keeps each boundary vector less its least entry, so a
shard of any length stays clear of INF, and ``cost0`` is the payload bits
saturated at INF.

The JAX function advances U = 16 positions per scan step to cut the TPU's
memory traffic; the plain version here steps one position at a time, which
gives the same integers (min and saturated + commute).
:func:`opt_ext_choice` launches the CUDA kernels (``csrc/opt_parse.cu``,
entry ``tpt_opt_ext_choice``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..constants import HUFFMAN_LENGTHS, compute_min_pattern_size
from .opt_parse import (
    INF, block_size, combine_plain, from_steps, identity, launch_dp,
    to_steps,
)

__all__ = ["opt_ext_choice", "opt_ext_choice_plain", "chunk_weights",
           "ext_advance_bits"]

B_EXT = 2048  # positions a block of X4's kernels
CHUNK_EXT = 256  # X4's blocks are a multiple of its staged chunk


def ext_advance_bits(window: int, literal: int) -> list[int]:
    """Token bits of a match of advance s = 1 .. K at index s - 1 (0 where
    no match has that size: advance 1 and sizes below minp)."""
    minp = compute_min_pattern_size(window, literal)
    K = minp + 131
    bits = [0] * K
    for s in range(minp, minp + 12):
        bits[s - 1] = HUFFMAN_LENGTHS[s - minp] + window
    for s in range(minp + 12, K + 1):
        v = s - minp - 12
        bits[s - 1] = (HUFFMAN_LENGTHS[13] + HUFFMAN_LENGTHS[v >> 3] - 1 + 3
                       + window)
    return bits


def chunk_weights(sideband_pos: torch.Tensor, sideband_cw: torch.Tensor,
                  NP: int) -> torch.Tensor:
    """(S, NP) int32 chain weights: ``sideband_cw`` at the positions
    ``sideband_pos`` (each shard's RLE chunk starts), 0 elsewhere; entries
    at positions >= NP are padding."""
    S = sideband_pos.shape[0]
    pos = sideband_pos.to(torch.int64)
    # padding lands in a spare column NP (no mask, so no device sync)
    pos = torch.where((pos >= 0) & (pos < NP), pos, NP)
    cw = torch.zeros((S, NP + 1), dtype=torch.int32,
                     device=sideband_pos.device)
    cw.scatter_(1, pos, sideband_cw.to(torch.int32))
    return cw[:, :NP].contiguous()


def opt_ext_choice_plain(packed: torch.Tensor, data, npos: torch.Tensor,
                         sideband_pos: torch.Tensor,
                         sideband_cw: torch.Tensor, *, window: int,
                         literal: int, B: int = 1024):
    """X4 in tensor ops on the inputs' device: (choice (S, NP) uint8,
    cost0 (S,) int32, bad (S,) bool), with B positions a block."""
    S, NP = packed.shape
    dev = packed.device
    B = block_size(NP, B)
    n_b = NP // B
    minp = compute_min_pattern_size(window, literal)
    K = minp + 131
    lit_limit = 256 if literal == 8 else (1 << literal)
    i32 = dict(dtype=torch.int32, device=dev)
    inf = torch.tensor(INF, **i32)
    zero = torch.zeros((), **i32)

    in_shard = (torch.arange(NP, device=dev)[None, :]
                < npos.to(dev, torch.int64)[:, None])
    flen = torch.where(in_shard, packed & 0xFF, zero)
    room = ((packed >> 8) & 0x7FFF) + 1
    bound = (packed >> 23) & 0xFF
    interior = torch.where(in_shard, (packed >> 31) & 1, zero)
    if literal < 8:
        eligible = data.to(torch.int32) < lit_limit
    else:
        eligible = torch.ones((S, NP), dtype=torch.bool, device=dev)
    # free-literal padding keeps the boundary condition uniform (cost 0
    # from npos on); in-shard ineligible literals cost INF
    lc = torch.where(in_shard, torch.where(
        eligible, torch.tensor(1 + literal, **i32), inf), zero)
    cw = chunk_weights(sideband_pos, sideband_cw, NP)

    bits_vec = torch.tensor(ext_advance_bits(window, literal), **i32)
    s_vec = torch.arange(1, K + 1, **i32)
    is_match = s_vec >= minp
    is_ext = s_vec >= minp + 12
    r0 = s_vec == 1  # the literal / chain slot

    steps = tuple(to_steps(p, n_b, B)
                  for p in (flen, room, bound, interior, cw, lc))

    def cs_vec(k):
        """(S, n_b, K) per-advance costs at step k."""
        f, r_, b_, t_, c_, l_ = (x[k][:, :, None] for x in steps)
        valid = is_match & (f >= s_vec) & (b_ >= s_vec) & (
            ~is_ext | (r_ >= s_vec))
        cs = torch.where(valid, bits_vec, inf)
        cs = torch.where(r0, torch.where(t_ == 1, c_, l_), cs)
        # interior positions: the chain edge is the only one
        return torch.where((t_ == 1) & ~r0, inf, cs)

    # pass 1: block transfer matrices
    M = identity(S, n_b, K, dev)
    for k in range(B):
        new = torch.clamp_max((M + cs_vec(k)[:, :, :, None]).amin(2), INF)
        M = torch.cat([new[:, :, None], M[:, :, : K - 1]], dim=2)

    bounds, v0 = combine_plain(M)
    del M

    # pass 2: exact costs and the first minimal advance
    ins_s = to_steps(in_shard, n_b, B)
    cur = bounds
    bad = torch.zeros((S, n_b), dtype=torch.bool, device=dev)
    ch = torch.empty((B, S, n_b), dtype=torch.uint8, device=dev)
    for k in range(B):
        cost_all = torch.clamp_max(cs_vec(k) + cur, INF)
        cost = cost_all.amin(2)
        ch[k] = (cost_all.argmin(2) + 1).to(torch.uint8)
        bad |= ins_s[k] & (steps[3][k] == 0) & (cost >= INF)
        cur = torch.cat([cost[:, :, None], cur[:, :, : K - 1]], dim=2)
    return from_steps(ch), v0[:, 0].contiguous(), bad.any(dim=1)


def opt_ext_choice(packed: torch.Tensor, data, npos: torch.Tensor,
                   sideband_pos: torch.Tensor, sideband_cw: torch.Tensor, *,
                   window: int, literal: int):
    """(choice (S, NP) uint8, cost0 (S,) int32, bad (S,) bool) of the
    optimal extended parse: kernel X4 for CUDA tensors, the plain version
    for CPU tensors.

    ``packed``: (S, NP) int32 ``flen | (room - 1) << 8 | bound << 23 |
    interior << 31`` (flen the khat-aware cap-maxpat match length, room
    the ring-end cap, bound the distance to the next forced-region start
    clipped to 255, interior set inside a region); ``data``: (S, NP) uint8
    shard bytes, read only for ``literal < 8`` (else may be None);
    ``npos``: (S,) int32 lengths; ``sideband_pos``/``sideband_cw``: (S, C)
    int32 RLE chunk starts and their token bits, padding entries at
    positions >= NP."""
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError("packed must be an (S, NP) int32 tensor")
    S, NP = packed.shape
    if literal < 8 and (data is None or data.dtype != torch.uint8
                        or data.shape != packed.shape):
        raise ValueError("literal < 8 needs data as an (S, NP) uint8 tensor")
    if npos.dtype != torch.int32 or npos.shape != (S,):
        raise ValueError("npos must be an (S,) int32 tensor")
    if sideband_pos.dim() != 2 or sideband_pos.shape != sideband_cw.shape \
            or sideband_pos.shape[0] != S:
        raise ValueError("the sideband must be two (S, C) tensors")
    devs = {packed.device, npos.device, sideband_pos.device,
            sideband_cw.device} | ({data.device} if literal < 8 else set())
    if len(devs) != 1:
        raise ValueError("all inputs must share one device")
    if packed.device.type == "cpu":
        return opt_ext_choice_plain(packed, data, npos, sideband_pos,
                                    sideband_cw, window=window,
                                    literal=literal)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    minp = compute_min_pattern_size(window, literal)
    B = block_size(NP, B_EXT)
    cw = chunk_weights(sideband_pos, sideband_cw, NP)
    data = data.contiguous() if literal < 8 else None
    packed = packed.contiguous()
    NPk = NP
    if B % CHUNK_EXT:
        # a shard below B_EXT: pad it to the kernels' chunk with positions
        # past npos (free literals), which change no cost or choice before
        NPk = B = -(-NP // CHUNK_EXT) * CHUNK_EXT
        pad = (0, NPk - NP)
        packed, cw = (torch.nn.functional.pad(x, pad) for x in (packed, cw))
        if data is not None:
            data = torch.nn.functional.pad(data, pad)
    choice, cost0, bad = launch_dp(
        "tpt_opt_ext_choice", packed.device, S, NPk, B, minp + 131,
        torch.uint8, (packed, data, npos.contiguous(), cw), window, literal)
    opt_ext_choice.launches += 1
    return choice[:, :NP].contiguous(), cost0, bad


opt_ext_choice.launches = 0

"""Token-boundary chase (kernel B8) and its plain version.

Counterpart of ``tamp_tpu/ops/token_chase_pallas.py::token_table_chase``:
the real token starts of each shard are the orbit of the per-bit jump
array ``nxt`` (S, NBP) int32 (ops/decode_wavefront.py's parse) from bit 0.
A bit whose ``nxt`` is NBP is an incomplete trailing token: it is dropped
and the chase ends.  Output: ``starts`` (S, T_max) int32, the starts in
order and zero past them (slots at or past ``T_max`` dropped), and ``T`` (S,)
int32, their count clipped to ``T_max``; the contract of
``decode_wavefront._token_table`` wherever ``T_max`` holds every start.  A
hop that does not advance ends the chase too.  The CUDA kernel is
``csrc/decode_wavefront.cu``: exit maps over tiles of ``TILE`` bits, one
lookup a tile for the entries, then every visited tile packs its own
starts.  A map keeps the first ``SPAN`` entry bits of its tile, which
every plane the parse makes respects (a token is at most 35 bits); on a
plane whose chase hops ``SPAN`` or more bits past a tile's end the kernel
sets a flag and the wrapper raises ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["token_table_chase", "token_table_chase_plain", "TILE", "SPAN"]

TILE = 4096  # bits of nxt a tile of the kernel (csrc/decode_wavefront.cu CT)
SPAN = 64    # entry bits of a tile that keep an exit map


def token_table_chase_plain(nxt: torch.Tensor, NBP: int, T_max: int):
    """B8 as a Python chase per shard (on a host copy of ``nxt``); results
    are returned on its device."""
    S = nxt.shape[0]
    rows = nxt.cpu().numpy()
    starts = np.zeros((S, T_max), np.int32)
    T = np.zeros(S, np.int32)
    for s in range(S):
        row = rows[s].tolist()
        c = k = 0
        while c < NBP:
            n = row[c]
            if n >= NBP or n <= c:  # incomplete trailing token: drop, stop
                break
            if k < T_max:
                starts[s, k] = c
            k += 1
            c = n
        T[s] = min(k, T_max)
    dev = nxt.device
    return torch.from_numpy(starts).to(dev), torch.from_numpy(T).to(dev)


def token_table_chase(nxt: torch.Tensor, NBP: int, T_max: int):
    """(starts (S, T_max), T (S,)) int32: kernel B8 for CUDA tensors, the
    plain version for CPU tensors."""
    if nxt.dtype != torch.int32 or nxt.dim() != 2 or nxt.shape[1] != NBP:
        raise ValueError("nxt must be an (S, NBP) int32 tensor")
    if nxt.device.type == "cpu":
        return token_table_chase_plain(nxt, NBP, T_max)
    if nxt.device.type != "cuda":
        raise ValueError(f"unsupported device {nxt.device}")
    nxt = nxt.contiguous()
    S = nxt.shape[0]
    dev = nxt.device
    n_tiles = -(-NBP // TILE)
    starts = torch.zeros((S, T_max), dtype=torch.int32, device=dev)
    T = torch.empty(S, dtype=torch.int32, device=dev)
    # the kernel's workspace: each tile's exit maps, each visited tile's
    # entry bit and output offset, and per shard (tiles visited, error)
    ws = (torch.empty((S, n_tiles, SPAN), dtype=torch.int32, device=dev),
          torch.empty((S, 2, n_tiles), dtype=torch.int32, device=dev),
          torch.empty((S, 2), dtype=torch.int32, device=dev))
    _build.launch("decode_wavefront", "tpt_token_chase", dev,
                  (nxt, starts, T, *ws), (S, NBP, T_max, n_tiles))
    token_table_chase.launches += 1
    if S and bool(ws[2][:, 1].any()):
        raise RuntimeError(
            f"token_table_chase: the chase hops {SPAN} or more bits past a "
            f"{TILE}-bit tile's end, which no parse makes")
    return starts, T


token_table_chase.launches = 0

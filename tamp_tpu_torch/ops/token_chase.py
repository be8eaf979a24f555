"""Token-boundary chase (kernel B8) and its plain version.

Counterpart of ``tamp_tpu/ops/token_chase_pallas.py::token_table_chase``:
the real token starts of each shard are the orbit of the per-bit jump
array ``nxt`` (S, NBP) int32 (ops/decode_wavefront.py's parse) from bit 0.
A bit whose ``nxt`` is NBP is an incomplete trailing token: it is dropped
and the chase ends.  Output: ``starts`` (S, T_max) int32, the starts in
order and zero past them, and ``T`` (S,) int32, their count; the same
contract as ``decode_wavefront._token_table``.  The CUDA kernel is
``csrc/decode_wavefront.cu``; it writes the compact table directly, so the
TPU kernel's per-tile rows and their compaction have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["token_table_chase", "token_table_chase_plain"]


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
    starts = torch.zeros((S, T_max), dtype=torch.int32, device=nxt.device)
    T = torch.empty(S, dtype=torch.int32, device=nxt.device)
    _build.launch("decode_wavefront", "tpt_token_chase", nxt.device,
                  (nxt, starts, T), (S, NBP, T_max))
    token_table_chase.launches += 1
    return starts, T


token_table_chase.launches = 0

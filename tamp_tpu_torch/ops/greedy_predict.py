"""Speculative greedy walk (kernel B7), its plain version, and its input plane.

Counterpart of ``tamp_tpu/ops/greedy_predict_pallas.py``.  The greedy-parity
encode (engine/pipeline_ext.encode_ext_device_greedy) computes cap-16 (and
probe) tables on the card, but the authoritative greedy walk runs in the
host committer (engine/greedy.py), whose output never depends on which
table entries it receives.  So the card ships entries only at the
positions a replay of the reference greedy step predicts the committer will
visit: this walk, over the packed plane ``idx16 | len16 << 15 | run << 20``
(:func:`pack_predict_plane`).  Per step at position t:

- ``ln = (p >> 15) & 31``, ``run = (p >> 20) & 255``, ``matchy = ln >= minp``;
- RLE first: a run of 2..6 bytes that the match beats (``ln > run``) is
  searched (``use_pattern``), any other run of 2+ consumes
  ``min(run, 241)`` bytes;
- lazy: a match of minp..8 bytes defers to a literal when the probe word
  ``pidx | plen << 15`` is longer and its source does not cover the write
  head ``t & (W - 1)``;
- an entry (the packed word, then the probe word when lazy) is emitted when
  ``matchy`` and ``run <= 6``; its bit t is set in the start bitmap;
- the walk stops at ``npos - 15`` (the committer's tail searches itself).

Outputs per shard: the start bitmap (NP / 32 int32 words, every word
written), the compact entry row (EPAD int32; entries past ``ne`` are not
written by the kernel) and the state row ``(ne, t, ne // 128, 0...)`` (the
TPU's third slot counts flushed 128-word chunks).  The CUDA kernel is
``csrc/greedy_predict.cu`` (entry ``tpt_greedy_predict``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import compute_min_pattern_size
from . import _build
from .plan_ext import _rcummin

__all__ = ["pack_predict_plane", "greedy_predict_batch",
           "greedy_predict_plain", "entry_pad", "P_NE", "P_T", "P_FL",
           "P_NSLOTS", "ECHUNK_W"]

ECHUNK_W = 128  # the TPU kernel's entry flush granularity (state slot P_FL)
P_NE, P_T, P_FL, P_NSLOTS = 0, 1, 2, 8  # state-row slots


def entry_pad(NP: int, lazy: bool) -> int:
    """Entry row length: a non-lazy entry advances >= 2 positions, a lazy
    deferral can emit a pair at advance 1."""
    return (2 * NP if lazy else NP // 2) + 2 * ECHUNK_W


def pack_predict_plane(dh: torch.Tensor, npos: torch.Tensor,
                       len16: torch.Tensor, idx16: torch.Tensor, *,
                       dlast: int) -> torch.Tensor:
    """Packed walker plane ``idx16 | len16 << 15 | run << 20`` (S, NP) int32.

    ``run[t]``: the count of bytes from t on equal to the PREVIOUS byte
    (``dlast``, the dictionary's last byte, before position 0), capped at
    255; 0 at run breaks and beyond ``npos``.  ``len16`` is clipped to
    0..16 and zeroed beyond ``npos``.  ``dh``: (S, NP) byte values."""
    S, NP = dh.shape
    dh = dh.to(torch.int32)
    p_i = torch.arange(NP, dtype=torch.int32, device=dh.device).expand(S, NP)
    last = torch.roll(dh, 1, dims=1)
    last[:, 0] = dlast
    valid = p_i < npos.to(torch.int32)[:, None]
    chg = (dh != last) | ~valid
    nch = _rcummin(torch.where(chg, p_i, NP))
    nch_after = torch.roll(nch, -1, dims=1)
    nch_after[:, -1] = NP
    run = torch.where(chg, 0, torch.clamp_max(nch_after - p_i, 255))
    ln = torch.where(valid, torch.clamp(len16, 0, 16), 0)
    return ((idx16 & 0x7FFF) | (ln << 15) | (run << 20)).to(torch.int32)


def _walk(pk, pp, hard_stop: int, *, wmask: int, minp: int, lazy: bool):
    """One shard's walk on Python ints: (start positions, entries, t)."""
    starts, ent = [], []
    t = 0
    while t < hard_stop:
        p = pk[t]
        ln = (p >> 15) & 31
        run = (p >> 20) & 255
        matchy = ln >= minp
        rle_go = run >= 2 and not (run <= 6 and ln > run)
        go_lazy = False
        if lazy:
            q = pp[t]
            pix, psz, tau = q & 0x7FFF, (q >> 15) & 15, t & wmask
            go_lazy = (matchy and ln <= 8 and psz > ln and not rle_go
                       and not pix <= tau < pix + psz)
        if matchy and run <= 6:
            starts.append(t)
            ent.append(p)
            if lazy:
                ent.append(q)
        if rle_go:
            t += min(run, 241)
        else:
            t += ln if matchy and not go_lazy else 1
    return starts, ent, t


def greedy_predict_plain(pk: torch.Tensor, pp: torch.Tensor | None,
                         npos: torch.Tensor, *, NP: int, window: int,
                         literal: int, lazy: bool):
    """B7 as a Python loop per shard (on host copies of the inputs);
    results on the inputs' device, entries past ``ne`` zero."""
    S = pk.shape[0]
    minp = compute_min_pattern_size(window, literal)
    k_h = pk.cpu().numpy()
    q_h = pp.cpu().numpy() if lazy else k_h
    n_h = npos.cpu().numpy()
    bm = np.zeros((S, NP), np.uint8)
    ent = np.zeros((S, entry_pad(NP, lazy)), np.int32)
    state = np.zeros((S, P_NSLOTS), np.int32)
    for s in range(S):
        stop = min(int(n_h[s]) - 15, NP)
        lim = max(stop, 0)
        starts, e, t = _walk(k_h[s, :lim].tolist(), q_h[s, :lim].tolist(),
                             stop, wmask=(1 << window) - 1, minp=minp,
                             lazy=lazy)
        bm[s, starts] = 1
        ent[s, : len(e)] = e
        state[s, [P_NE, P_T, P_FL]] = (len(e), t, len(e) // ECHUNK_W)
    words = np.packbits(bm, axis=1, bitorder="little").view("<i4")
    dev = pk.device
    return (torch.from_numpy(words.copy()).to(dev),
            torch.from_numpy(ent).to(dev), torch.from_numpy(state).to(dev))


def greedy_predict_batch(pk: torch.Tensor, pp: torch.Tensor | None,
                         npos: torch.Tensor, *, NP: int, window: int,
                         literal: int, lazy: bool):
    """(bitmap (S, NP / 32), entries (S, EPAD), state (S, 8)), int32: kernel
    B7 for CUDA tensors, the plain version for CPU tensors.

    ``pk``: (S, NP) int32 packed plane (:func:`pack_predict_plane`);
    ``pp``: (S, NP) int32 probe plane ``pidx | plen << 15`` (read only when
    ``lazy``; may be None otherwise); ``npos``: (S,) int32.  The entry
    count of a shard is the popcount of its bitmap row, doubled when lazy
    (main and probe word pairs, in walk order)."""
    if pk.dtype != torch.int32 or pk.dim() != 2 or pk.shape[1] != NP:
        raise ValueError("pk must be an (S, NP) int32 tensor")
    if NP % 32:
        raise ValueError("NP must be a multiple of 32 (bitmap words)")
    if lazy and (pp is None or pp.dtype != torch.int32
                 or pp.shape != pk.shape or pp.device != pk.device):
        raise ValueError("lazy needs pp, an (S, NP) int32 tensor beside pk")
    if npos.dtype != torch.int32 or npos.shape != (pk.shape[0],) \
            or npos.device != pk.device:
        raise ValueError("npos must be an (S,) int32 tensor beside pk")
    if pk.device.type == "cpu":
        return greedy_predict_plain(pk, pp, npos, NP=NP, window=window,
                                    literal=literal, lazy=lazy)
    if pk.device.type != "cuda":
        raise ValueError(f"unsupported device {pk.device}")
    S = pk.shape[0]
    dev = pk.device
    epad = entry_pad(NP, lazy)
    bm = torch.empty((S, NP // 32), dtype=torch.int32, device=dev)
    ent = torch.empty((S, epad), dtype=torch.int32, device=dev)
    state = torch.empty((S, P_NSLOTS), dtype=torch.int32, device=dev)
    pk = pk.contiguous()
    _build.launch("greedy_predict", "tpt_greedy_predict", dev,
                  (pk, pp.contiguous() if lazy else pk, npos.contiguous(), bm,
                   ent, state),
                  (S, NP, epad, window,
                   compute_min_pattern_size(window, literal), int(lazy)))
    greedy_predict_batch.launches += 1
    return bm, ent, state


greedy_predict_batch.launches = 0

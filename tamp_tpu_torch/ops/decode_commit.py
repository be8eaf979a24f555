"""Decode commit (kernel B4) and its plain version.

Counterpart of ``tamp_tpu/ops/decode_commit_pallas.py::commit_decode_batch``
(the ``_kernel`` kernel, separate-ring form for every stream and window).
Input: the per-bit parse of S payloads (ops/decode_wavefront.py) as
``nxt`` and ``packed = kind | cnt << 3 | idx << 11``, both (S, NBP) int32;
they are fused into one word per bit, ``kind(3) | cnt(8) | delta(6) |
idx << 17`` with ``delta = 0`` where ``nxt >= NBP`` (a trailing incomplete
token), else ``min(nxt - b, 63)``.  Output: decoded bytes (S, max_out)
uint8 (zero past each length), lengths (S,) and error codes (S,) int32.
Window-write rules (reference decompressor): basic matches write fully
with wrap; RLE writes at most 8 bytes and never wraps; extended matches
never wrap; a double FLUSH on a ``more`` stream resets the ring to
``dict_reset``.  The CUDA kernel is ``csrc/decode_commit.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["commit_decode", "commit_decode_plain", "fuse_parse",
           "ERR_OK", "ERR_INVALID", "ERR_OOB", "ERR_OVERFLOW"]

ERR_OK, ERR_INVALID, ERR_OOB, ERR_OVERFLOW = 0, 1, 2, 3
K_LIT, K_MATCH, K_RLE, K_EXT, K_FLUSH = 0, 1, 2, 3, 4  # parse token kinds


def fuse_parse(nxt: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """One int32 word per bit: ``kind | cnt << 3 | delta << 11 | idx << 17``
    (the JAX package's packing; idx << 17 wraps into the sign bit for
    window 15, and the kernel masks it back)."""
    NBP = nxt.shape[1]
    b = torch.arange(NBP, dtype=torch.int64, device=nxt.device)[None, :]
    nx = nxt.to(torch.int64)
    delta = torch.where(nx >= NBP, 0, torch.clamp_max(nx - b, 63))
    pk = packed.to(torch.int64)
    word = ((pk & 0x7FF) | (delta << 11) | ((pk >> 11) << 17)) & 0xFFFFFFFF
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(
        torch.int32)


def _walk(pk, W: int, more: bool, max_out: int, dict_init: bytes,
          dict_reset: bytes, out: np.ndarray):
    """One shard's walk on Python ints; returns (out_len, err)."""
    ring = bytearray(dict_init)
    NBP = len(pk)
    c = out_pos = pos = lwf = 0
    err = ERR_OK
    while c < NBP:
        p = pk[c]
        kind = p & 7
        cnt = (p >> 3) & 0xFF
        delta = (p >> 11) & 63
        idx = (p >> 17) & (W - 1)
        if delta == 0:
            break
        if kind in (K_MATCH, K_EXT) and idx + cnt > W:
            err = ERR_OOB
        if kind != K_FLUSH and out_pos + cnt > max_out:
            err = ERR_OVERFLOW
        if err:
            break
        c += delta
        if kind == K_FLUSH:
            if more and lwf:
                ring[:] = dict_reset
                pos = 0
            lwf = 1
            continue
        lwf = 0
        if kind == K_LIT:
            out[out_pos] = idx
            ring[pos] = idx
            wr = 1
        elif kind == K_RLE:
            b = ring[pos - 1]  # pos 0 reads ring[-1] == ring[W - 1]
            out[out_pos : out_pos + cnt] = b
            wr = min(cnt, 8, W - pos)
            ring[pos : pos + wr] = bytes([b]) * wr
        else:
            src = bytes(ring[idx : idx + cnt])  # snapshot before writing
            out[out_pos : out_pos + cnt] = np.frombuffer(src, np.uint8)
            wr = min(cnt, W - pos) if kind == K_EXT else cnt
            first = min(wr, W - pos)
            ring[pos : pos + first] = src[:first]
            ring[: wr - first] = src[first:wr]
        pos = (pos + wr) & (W - 1)
        out_pos += cnt
    return out_pos, err


def commit_decode_plain(pk: torch.Tensor, dict_init: torch.Tensor,
                        dict_reset: torch.Tensor, *, W: int, more: bool,
                        max_out: int):
    """B4 as a Python loop per shard (on host copies of the inputs); results
    are returned on the inputs' device."""
    S = pk.shape[0]
    pk_h = pk.cpu().numpy()
    di = bytes(dict_init.cpu().numpy().tobytes())
    dr = bytes(dict_reset.cpu().numpy().tobytes())
    out = np.zeros((S, max_out), np.uint8)
    lens = np.zeros(S, np.int32)
    errs = np.zeros(S, np.int32)
    for s in range(S):
        lens[s], errs[s] = _walk(pk_h[s].tolist(), W, more, max_out, di, dr,
                                 out[s])
    dev = pk.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(errs).to(dev))


def commit_decode(nxt: torch.Tensor, packed: torch.Tensor,
                  dict_init: torch.Tensor, dict_reset: torch.Tensor, *,
                  W: int, more: bool, max_out: int):
    """(out (S, max_out) uint8, lens (S,), errs (S,)): kernel B4 for CUDA
    tensors, the plain version for CPU tensors."""
    if nxt.dtype != torch.int32 or packed.dtype != torch.int32 \
            or nxt.dim() != 2 or nxt.shape != packed.shape:
        raise ValueError("nxt and packed must be (S, NBP) int32 tensors")
    for d in (dict_init, dict_reset):
        if d.dtype != torch.uint8 or d.shape != (W,):
            raise ValueError("dictionaries must be (W,) uint8 tensors")
    if not (nxt.device == packed.device == dict_init.device
            == dict_reset.device):
        raise ValueError("all inputs must share one device")
    pk = fuse_parse(nxt, packed)
    if pk.device.type == "cpu":
        return commit_decode_plain(pk, dict_init, dict_reset, W=W, more=more,
                                   max_out=max_out)
    if pk.device.type != "cuda":
        raise ValueError(f"unsupported device {pk.device}")
    return _launch(pk, dict_init.contiguous(), dict_reset.contiguous(), W=W,
                   more=more, max_out=max_out)


def _launch(pk, dict_init, dict_reset, *, W: int, more: bool, max_out: int):
    S, NBP = pk.shape
    if NBP % 4 or not pk.is_contiguous():
        raise ValueError("the kernel stages parse words in 16-byte units: "
                         "pk must be contiguous with NBP a multiple of 4")
    dev = pk.device
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
    lens = torch.empty(S, dtype=torch.int32, device=dev)
    errs = torch.empty(S, dtype=torch.int32, device=dev)
    _build.launch("decode_commit", "tpt_commit_decode", dev,
                  (pk, dict_init, dict_reset, out, lens, errs),
                  (S, NBP, W.bit_length() - 1, int(more), max_out))
    commit_decode.launches += 1
    return out, lens, errs


commit_decode.launches = 0

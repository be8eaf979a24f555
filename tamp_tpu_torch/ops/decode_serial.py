"""Token-serial device decode (kernel X2) and its plain version.

Counterpart of ``tamp_tpu/ops/decode_jax.py`` (``decode_shards_device``,
``algorithm="serial"`` of the container decode): each shard's stream is
decoded token by token, one parse lane per shard, against a window ring.  Its
contract is ``decode_jax``'s:

- the decode stops before a token once ``max_out`` bytes are out, with no
  overflow error (the output is cut at ``max_out``);
- a token the remaining bits cannot complete ends the decode quietly;
- FLUSH drops ``bits % 8`` (aligns to the next byte);
- any error (a match reading past the window) raises ``ValueError``.

Where ``decode_jax`` departs from the reference decoder, this module
follows the native decoder: a double-FLUSH reset loads the default
dictionary even when the stream began from a custom one, a custom
dictionary is cut to the window (and must fill it), and a nonzero reserved
header byte on a ``more`` stream is an error.  The CUDA kernel is
``csrc/decode_serial.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..constants import (
    EXTENDED_MATCH_SYMBOL,
    FLUSH_SYMBOL,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    RLE_SYMBOL,
    compute_min_pattern_size,
)
from ..device import resolve_device
from ..exceptions import OutOfBoundsError
from . import _build
from .decode_wavefront import split_streams

__all__ = ["decode_shards_device", "decode_stream", "padded_width",
           "serial_decode", "serial_decode_plain", "MAX_DECODED",
           "BYTES_PER_BIT"]

ERR_OK, ERR_OOB = 0, 2
# The largest max_out X2 takes: it keeps output offsets in int, and the
# token that crosses max_out carries the count up to 240 bytes past it.
MAX_DECODED = (1 << 31) - 256
# No token decodes to more bytes a bit than this: the densest is an RLE
# token of 19 bits (second symbol 13, 4 trail bits) writing 225 bytes,
# 11.84 a bit.
BYTES_PER_BIT = 12

# symbol and code length (flag excluded) of every 8-bit peek
_PEEK = [None] * 256
for _s in range(15):
    _nb = HUFFMAN_LENGTHS[_s] - 1
    for _j in range(1 << (8 - _nb)):
        _PEEK[(HUFFMAN_CODES[_s] << (8 - _nb)) | _j] = (_s, _nb)


def _decode_one(src: bytes, ring: bytearray, dict_reset: bytes, out,
                *, window: int, literal: int, extended: bool, more: bool,
                max_out: int):
    """One shard's decode on Python ints; returns (out_len, err)."""
    W = 1 << window
    wmask = W - 1
    minp = compute_min_pattern_size(window, literal)
    n = len(src)
    acc = bits = ip = o = pos = lwf = 0
    err = ERR_OK

    def field(frm, nb):
        return (acc >> (frm - nb)) & ((1 << nb) - 1)

    def peek8(frm):
        return field(frm, 8) if frm >= 8 else (acc << (8 - frm)) & 0xFF

    while o < max_out:
        while bits <= 56 and ip < n:
            acc = ((acc << 8) | src[ip]) & ((1 << 64) - 1)
            ip += 1
            bits += 8
        if bits < 1:
            break
        if field(bits, 1):  # literal
            if bits < 1 + literal:
                break
            v = field(bits - 1, literal)
            bits -= 1 + literal
            out[o] = v
            o += 1
            ring[pos] = v
            pos = (pos + 1) & wmask
            lwf = 0
            continue
        b1 = bits - 1
        if b1 < 1:
            break
        s1, l1 = _PEEK[peek8(b1)]
        if l1 > b1:
            break
        b2 = b1 - l1
        if s1 == FLUSH_SYMBOL:
            bits = b2 - (b2 & 7)
            if more and lwf:
                ring[:] = dict_reset
                pos = 0
            lwf = 1
            continue
        if extended and s1 in (RLE_SYMBOL, EXTENDED_MATCH_SYMBOL):
            if b2 < 1:
                break
            s2, l2 = _PEEK[peek8(b2)]
            if l2 > b2:
                break
            b3 = b2 - l2
            if s1 == RLE_SYMBOL:
                if b3 < 4:
                    break
                cnt = (s2 << 4) + field(b3, 4) + 2
                bits = b3 - 4
                kind = "rle"
            else:
                if b3 < 3 + window:
                    break
                cnt = (s2 << 3) + field(b3, 3) + minp + 12
                idx = field(b3 - 3, window)
                bits = b3 - 3 - window
                kind = "ext"
        else:
            if b2 < window:
                break
            cnt = s1 + minp
            idx = field(b2, window)
            bits = b2 - window
            kind = "match"
        if kind != "rle" and idx + cnt > W:
            err = ERR_OOB
            break
        lwf = 0
        n_out = min(cnt, max_out - o)
        if kind == "rle":
            b = ring[(pos - 1) & wmask]
            out[o : o + n_out] = b
            wr = min(cnt, 8, W - pos)
            ring[pos : pos + wr] = bytes([b]) * wr
        else:
            snap = bytes(ring[idx : idx + cnt])
            out[o : o + n_out] = np.frombuffer(snap[:n_out], np.uint8)
            wr = min(cnt, W - pos) if kind == "ext" else cnt
            first = min(wr, W - pos)
            ring[pos : pos + first] = snap[:first]
            ring[: wr - first] = snap[first:wr]
        pos = (pos + wr) & wmask
        o += cnt
    return min(o, max_out), err


def padded_width(Lp: int) -> int:
    """The row width, a multiple of 16 of at least ``Lp`` (and 16), that
    kernel X2 takes: it stages rows with 16-byte bulk copies."""
    return -(-max(Lp, 1) // 16) * 16


def serial_decode_plain(payloads: torch.Tensor, nbytes: torch.Tensor,
                        dict_init: torch.Tensor, dict_reset: torch.Tensor, *,
                        window: int, literal: int, extended: bool,
                        more: bool, max_out: int):
    """X2 as a Python decode per shard (on host copies of the inputs);
    results are returned on the inputs' device."""
    S = payloads.shape[0]
    pl = payloads.cpu().numpy()
    nb = nbytes.cpu().numpy()
    di = bytes(dict_init.cpu().numpy().tobytes())
    dr = bytes(dict_reset.cpu().numpy().tobytes())
    out = np.zeros((S, max_out), np.uint8)
    lens = np.zeros(S, np.int32)
    errs = np.zeros(S, np.int32)
    for s in range(S):
        lens[s], errs[s] = _decode_one(
            pl[s, : int(nb[s])].tobytes(), bytearray(di), dr, out[s],
            window=window, literal=literal, extended=extended, more=more,
            max_out=max_out)
    dev = payloads.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(errs).to(dev))


def serial_decode(payloads: torch.Tensor, nbytes: torch.Tensor,
                  dict_init: torch.Tensor, dict_reset: torch.Tensor, *,
                  window: int, literal: int, extended: bool, more: bool,
                  max_out: int):
    """(out (S, max_out) uint8, lens (S,), errs (S,)) of header-less
    payloads (S, Lp) uint8 with ``nbytes`` (S,) int32 valid bytes each:
    kernel X2 for CUDA tensors, the plain version for CPU tensors."""
    W = 1 << window
    if payloads.dtype != torch.uint8 or payloads.dim() != 2:
        raise ValueError("payloads must be an (S, Lp) uint8 tensor")
    if nbytes.dtype != torch.int32 or nbytes.shape != payloads.shape[:1]:
        raise ValueError("nbytes must be an (S,) int32 tensor")
    for d in (dict_init, dict_reset):
        if d.dtype != torch.uint8 or d.shape != (W,):
            raise ValueError("dictionaries must be (W,) uint8 tensors")
    if not (payloads.device == nbytes.device == dict_init.device
            == dict_reset.device):
        raise ValueError("all inputs must share one device")
    kw = dict(window=window, literal=literal, extended=extended, more=more,
              max_out=max_out)
    if payloads.device.type == "cpu":
        return serial_decode_plain(payloads, nbytes, dict_init, dict_reset,
                                   **kw)
    if payloads.device.type != "cuda":
        raise ValueError(f"unsupported device {payloads.device}")
    S, Lp = payloads.shape
    dev = payloads.device
    payloads = payloads.contiguous()
    if Lp != padded_width(Lp) or payloads.data_ptr() % 16:
        Lp = padded_width(Lp)
        padded = torch.zeros((S, Lp), dtype=torch.uint8, device=dev)
        padded[:, : payloads.shape[1]] = payloads
        payloads = padded
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
    lens = torch.empty(S, dtype=torch.int32, device=dev)
    errs = torch.empty(S, dtype=torch.int32, device=dev)
    _build.launch("decode_serial", "tpt_serial_decode", dev,
                  (payloads, nbytes.contiguous(),
                   dict_init.contiguous(), dict_reset.contiguous(), out,
                   lens, errs),
                  (S, Lp, window, literal, int(extended), int(more),
                   compute_min_pattern_size(window, literal), max_out))
    serial_decode.launches += 1
    return out, lens, errs


serial_decode.launches = 0


def decode_shards_device(shards, *, dictionary=None, max_out: int,
                         device=None) -> list[bytes]:
    """Decode same-config Tamp streams (header included) token by token on
    the card; ``max_out`` bounds each shard's decoded size (the output is
    cut there).  All shards must share one header configuration.  A match
    reading past the window raises OutOfBoundsError (a ValueError)."""
    dev = resolve_device(device)
    if not shards:
        return []
    with trace.span("tamp.decode.h2d"):
        (window, literal, extended, more, dict_init, default_dict,
         payloads) = split_streams(shards, dictionary)
        S = len(payloads)
        Lp = padded_width(max(len(p) for p in payloads))
        blobs = np.zeros((S, Lp), np.uint8)
        for i, p in enumerate(payloads):
            blobs[i, : len(p)] = np.frombuffer(p, np.uint8)
        nb = np.asarray([len(p) for p in payloads], np.int32)
        args = (torch.from_numpy(blobs).to(dev), torch.from_numpy(nb).to(dev),
                torch.from_numpy(np.array(dict_init, np.uint8)).to(dev),
                torch.from_numpy(default_dict).to(dev))
        trace.count("decode.h2d_bytes", sum(a.nbytes for a in args))
    with trace.span("tamp.decode.kernel", device=dev):
        out, lens, errs = serial_decode(
            *args, window=window, literal=literal, extended=extended,
            more=more, max_out=max_out)
        del args  # the inputs' device memory goes back before the pull
    with trace.span("tamp.decode.d2h"):
        errs = errs.cpu().numpy()
        if (errs == ERR_OOB).any():
            raise OutOfBoundsError(
                "window reference outside the window in shard(s) "
                f"{np.nonzero(errs == ERR_OOB)[0][:4]}")
        if errs.any():
            raise ValueError(
                f"invalid tamp stream in shard(s) {np.nonzero(errs)[0][:4]}")
        lens = lens.cpu().numpy()
        blk = out[:, : max(1, int(lens.max()))].cpu().numpy()
        trace.count("decode.d2h_bytes", errs.nbytes + lens.nbytes + blk.nbytes)
    with trace.span("tamp.decode.copy"):
        trace.count("decode.copy_bytes", int(lens.sum()))
        return [blk[i, : int(lens[i])].tobytes() for i in range(S)]


def decode_stream(data, *, dictionary=None, device=None) -> bytearray:
    """Decode one Tamp stream (header included) of unknown decoded size
    with kernel X2, the native decoder's contract: an empty stream, or a
    ``more`` stream with no reserved byte, decodes to nothing; a token the
    stream cannot complete ends the decode; a match reading past the
    window raises OutOfBoundsError, a bad header or a missing custom
    dictionary ValueError.

    X2 cuts its output at ``max_out``, so the decode starts from the
    native decoder's buffer (8 bytes a payload byte, at least 4096) and
    runs again with four times the room while the output fills it, up to
    one byte past the stream's bound (BYTES_PER_BIT a payload bit), which
    no stream fills.  A stream that fills MAX_DECODED bytes, X2's limit,
    raises ValueError."""
    dev = resolve_device(device)
    data = bytes(data)
    if not data or (data[0] & 1 and len(data) < 2):
        return bytearray()
    (window, literal, extended, more, dict_init, default_dict,
     (payload,)) = split_streams([data], dictionary)
    bound = BYTES_PER_BIT * 8 * len(payload)
    row = np.zeros((1, padded_width(len(payload))), np.uint8)
    row[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    args = (torch.from_numpy(row).to(dev),
            torch.tensor([len(payload)], dtype=torch.int32, device=dev),
            torch.from_numpy(np.array(dict_init, np.uint8)).to(dev),
            torch.from_numpy(default_dict).to(dev))
    room = max(4096, 8 * len(payload))
    while True:
        max_out = min(room, bound + 1, MAX_DECODED)
        out, lens, errs = serial_decode(
            *args, window=window, literal=literal, extended=extended,
            more=more, max_out=max_out)
        err, n = int(errs[0]), int(lens[0])
        if err == ERR_OOB:
            raise OutOfBoundsError("window reference outside the window")
        if err:
            raise ValueError(f"invalid tamp stream (error {err})")
        if n < max_out:
            return bytearray(out[0, :n].cpu().numpy().tobytes())
        if max_out == MAX_DECODED:
            raise ValueError(
                f"the stream decodes to more than {MAX_DECODED} bytes, the "
                "single-stream limit of the device decoder (kernel X2)")
        room *= 4

"""Decode commit (kernel B4) and its plain version.

Counterpart of ``tamp_tpu/ops/decode_commit_pallas.py::commit_decode_batch``
(the ``_kernel`` kernel, separate-ring form for every stream and window).
Input: the per-bit parse of S payloads (ops/decode_wavefront.py) as one
int32 word per bit, ``kind(3) | cnt(8) | delta(6) | idx << 17`` with
``delta = 0`` where ``nxt >= NBP`` (a trailing incomplete token), else
``min(nxt - b, 63)``: the parse kernel's fused form
(:func:`commit_decode_words`), or :func:`fuse_parse` of the pair form
``nxt`` and ``packed = kind | cnt << 3 | idx << 11``, both (S, NBP) int32
(:func:`commit_decode`).  Output: decoded bytes (S, max_out)
uint8 (zero past each length), lengths (S,) and error codes (S,) int32.
Window-write rules (reference decompressor): basic matches write fully
with wrap; RLE writes at most 8 bytes and never wraps; extended matches
never wrap; a double FLUSH on a ``more`` stream resets the ring to
``dict_reset``.  The CUDA kernel is ``csrc/decode_commit.cu``: a
tile-parallel front finds each shard's token words (exit maps over tiles of
:func:`front_tile` bits, one lookup a tile, every visited tile packing its
own words beside their running sums: :func:`commit_token_words_plain` and
:func:`front_sums_plain` are its plain version), then a cluster of two CTAs
a shard commits them in order, one cutting batches, one copying bytes.
The front's records take :func:`front_slots` slots a shard, from the
caller's floor on a token's bits (``min_bits``: 1 + literal for a parse).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["commit_decode", "commit_decode_words", "commit_decode_plain",
           "commit_token_words_plain", "front_sums_plain", "front_slots",
           "front_tile", "fuse_parse", "ERR_OK", "ERR_INVALID", "ERR_OOB",
           "ERR_OVERFLOW"]

ERR_OK, ERR_INVALID, ERR_OOB, ERR_OVERFLOW = 0, 1, 2, 3
K_LIT, K_MATCH, K_RLE, K_EXT, K_FLUSH = 0, 1, 2, 3, 4  # parse token kinds
TILE = 4096     # parse words of the kernel's largest front tile (csrc CT)
MIN_TILE = 512  # and of its smallest (csrc CT_MIN)
SPAN = 64       # entry bits of a front tile that keep an exit map


def front_tile(NBP: int) -> int:
    """Parse words a tile of the kernel's front: NBP / 64 rounded down to a
    power of two, within [MIN_TILE, TILE].  A lane of the front walks a
    whole tile, so a small plane takes small tiles and its walks stay
    short, while a plane of 64 * TILE bits or more keeps TILE."""
    return min(TILE, max(MIN_TILE, 1 << max(NBP // 64, 1).bit_length() - 1))


def front_slots(NBP: int, min_bits: int = 1) -> int:
    """Records a shard of the kernel's front: NBP // min_bits + 2 (the
    complete tokens of a chain whose tokens take ``min_bits`` bits or more,
    and its stop word), rounded up to even.  A shard whose chain holds that
    many complete tokens or more is refused with ERR_INVALID.  A parse's
    tokens take 1 + literal bits or more: a literal; a match takes 2 +
    window, a FLUSH 9."""
    return (NBP // min_bits + 3) & ~1


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


def _front(row) -> list:
    """One shard's chain over its parse words ``row`` (Python ints): the
    word of every token from bit 0 on, in order, up to and including the
    first word with delta 0 (an incomplete trailing token) or up to NBP."""
    NBP = len(row)
    words = []
    c = 0
    while c < NBP:
        p = row[c]
        words.append(p)
        delta = (p >> 11) & 63
        if delta == 0:
            break
        c += delta
    return words


def _walk(words, W: int, more: bool, max_out: int, dict_init: bytes,
          dict_reset: bytes, out: np.ndarray):
    """One shard's commit of its token words in order (:func:`_front`'s),
    on Python ints; returns (out_len, err)."""
    ring = bytearray(dict_init)
    out_pos = pos = lwf = 0
    err = ERR_OK
    for p in words:
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


def commit_token_words_plain(pk: torch.Tensor):
    """B4's front as a Python chain per shard (on a host copy of ``pk``
    (S, NBP) int32): (words (S, NBP) int32, T (S,) int32) on ``pk``'s
    device.  Row s holds the word of each of its T complete tokens (delta
    > 0) in order, copied verbatim, then the first word with delta 0 where
    the chain meets one before NBP, and zeros past.  The chain ignores the
    commit's errors: it runs to its end."""
    S, NBP = pk.shape
    rows = pk.cpu().numpy()
    words = np.zeros((S, NBP), np.int32)
    T = np.zeros(S, np.int32)
    for s in range(S):
        w = _front(rows[s].tolist())
        words[s, : len(w)] = w
        T[s] = len(w) - int(bool(w) and (w[-1] >> 11) & 63 == 0)
    dev = pk.device
    return torch.from_numpy(words).to(dev), torch.from_numpy(T).to(dev)


def front_sums_plain(words: torch.Tensor) -> torch.Tensor:
    """The running sum that the kernel's front keeps beside each compact
    word (:func:`commit_token_words_plain`'s ``words``): over the tokens
    before it, output bytes + ring bytes (before the ring end clamps them)
    << 16, mod 2^32, as int32; a FLUSH adds nothing.  The commit takes a
    batch's output and ring offsets from its differences."""
    w = words.to(torch.int64)
    kind, cnt = w & 7, (w >> 3) & 0xFF
    a = torch.where(kind == K_LIT, 1,
                    torch.where(kind == K_RLE, cnt.clamp_max(8), cnt))
    step = torch.where(kind == K_FLUSH, 0, cnt + (a << 16))
    sums = (torch.cumsum(step, 1) - step) & 0xFFFFFFFF
    return torch.where(sums >= 1 << 31, sums - (1 << 32), sums).to(
        torch.int32)


def commit_decode_plain(pk: torch.Tensor, dict_init: torch.Tensor,
                        dict_reset: torch.Tensor, *, W: int, more: bool,
                        max_out: int, min_bits: int = 1):
    """B4 as a Python loop per shard (on host copies of the inputs); results
    are returned on the inputs' device.  A shard whose chain holds
    :func:`front_slots` complete tokens or more gets ERR_INVALID and no
    bytes, as in the kernel."""
    return _plain(pk, dict_init, dict_reset, W, more, max_out, min_bits)[:3]


def _plain(pk, dict_init, dict_reset, W: int, more: bool, max_out: int,
           min_bits: int):
    """:func:`commit_decode_plain`'s (out, lens, errs) and the front's
    token counts T (S,)."""
    S, NBP = pk.shape
    cap = front_slots(NBP, min_bits)
    pk_h = pk.cpu().numpy()
    di = bytes(dict_init.cpu().numpy().tobytes())
    dr = bytes(dict_reset.cpu().numpy().tobytes())
    out = np.zeros((S, max_out), np.uint8)
    lens = np.zeros(S, np.int32)
    errs = np.zeros(S, np.int32)
    T = np.zeros(S, np.int32)
    for s in range(S):
        words = _front(pk_h[s].tolist())
        T[s] = len(words) - int(bool(words) and (words[-1] >> 11) & 63 == 0)
        if T[s] >= cap:
            errs[s] = ERR_INVALID
            continue
        lens[s], errs[s] = _walk(words, W, more, max_out, di, dr, out[s])
    dev = pk.device
    return tuple(torch.from_numpy(x).to(dev) for x in (out, lens, errs, T))


def _check_dicts(dict_init, dict_reset, W: int, device) -> None:
    for d in (dict_init, dict_reset):
        if d.dtype != torch.uint8 or d.shape != (W,):
            raise ValueError("dictionaries must be (W,) uint8 tensors")
    if not device == dict_init.device == dict_reset.device:
        raise ValueError("all inputs must share one device")


def commit_decode(nxt: torch.Tensor, packed: torch.Tensor,
                  dict_init: torch.Tensor, dict_reset: torch.Tensor, *,
                  W: int, more: bool, max_out: int):
    """(out (S, max_out) uint8, lens (S,), errs (S,)): kernel B4 for CUDA
    tensors, the plain version for CPU tensors, on the parse's pair form
    (fused by :func:`fuse_parse`)."""
    if nxt.dtype != torch.int32 or packed.dtype != torch.int32 \
            or nxt.dim() != 2 or nxt.shape != packed.shape:
        raise ValueError("nxt and packed must be (S, NBP) int32 tensors")
    _check_dicts(dict_init, dict_reset, W, nxt.device)
    if nxt.device != packed.device:
        raise ValueError("all inputs must share one device")
    return commit_decode_words(fuse_parse(nxt, packed), dict_init,
                               dict_reset, W=W, more=more, max_out=max_out)


def commit_decode_words(pk: torch.Tensor, dict_init: torch.Tensor,
                        dict_reset: torch.Tensor, *, W: int, more: bool,
                        max_out: int, min_bits: int = 1):
    """:func:`commit_decode` on the fused parse words ``pk`` (S, NBP) int32
    (:func:`fuse_parse`'s, or the fused form of the parse kernel).
    ``min_bits``: the fewest bits a token of ``pk`` takes (1 + literal for
    a parse), which sizes the front's records (:func:`front_slots`)."""
    return _commit_words(pk, dict_init, dict_reset, W=W, more=more,
                         max_out=max_out, min_bits=min_bits)[:3]


def _commit_words(pk, dict_init, dict_reset, *, W: int, more: bool,
                  max_out: int, min_bits: int):
    """:func:`commit_decode_words`'s (out, lens, errs) and the front's token
    counts T (S,) int32: the complete tokens of each shard's chain, read by
    the decode's counter ``decode.commit_tokens``."""
    if pk.dtype != torch.int32 or pk.dim() != 2:
        raise ValueError("pk must be an (S, NBP) int32 tensor")
    if min_bits < 1:
        raise ValueError("min_bits must be at least 1")
    _check_dicts(dict_init, dict_reset, W, pk.device)
    if pk.device.type == "cpu":
        return _plain(pk, dict_init, dict_reset, W, more, max_out, min_bits)
    if pk.device.type == "cuda":
        return _launch(pk, dict_init.contiguous(), dict_reset.contiguous(),
                       W=W, more=more, max_out=max_out,
                       min_bits=min_bits)[:4]
    raise ValueError(f"unsupported device {pk.device}")


def _launch(pk, dict_init, dict_reset, *, W: int, more: bool, max_out: int,
            min_bits: int = 1):
    """B4's four launches: (out, lens, errs, T, the front's records
    (S, front_slots(NBP, min_bits), 2) int32: each token's word and the
    running sum before it)."""
    S, NBP = pk.shape
    if NBP % 4 or not pk.is_contiguous():
        raise ValueError("the kernel stages parse words in 16-byte units: "
                         "pk must be contiguous with NBP a multiple of 4")
    dev = pk.device
    ct = front_tile(NBP)
    n_tiles = -(-NBP // ct)
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
    lens = torch.empty(S, dtype=torch.int32, device=dev)
    errs = torch.empty(S, dtype=torch.int32, device=dev)
    # the workspace: the front's compact records, each tile's exit maps,
    # each visited tile's entry bit, token offset and running sum, per
    # shard (tokens, tiles visited)
    cap = front_slots(NBP, min_bits)
    recs = torch.empty((S, cap, 2), dtype=torch.int32, device=dev)
    maps = torch.empty((S, n_tiles, SPAN, 2), dtype=torch.int32, device=dev)
    ent = torch.empty((S, 3, n_tiles), dtype=torch.int32, device=dev)
    tok = torch.empty((S, 2), dtype=torch.int32, device=dev)
    _build.launch("decode_commit", "tpt_commit_decode", dev,
                  (pk, dict_init, dict_reset, out, lens, errs, recs, maps,
                   ent, tok),
                  (S, NBP, cap, ct, W.bit_length() - 1, int(more),
                   max_out))
    commit_decode.launches += 1
    return out, lens, errs, tok[:, 0], recs


commit_decode.launches = 0

"""Device decode of same-config Tamp streams: per-bit parse + commit.

Counterpart of ``tamp_tpu/ops/decode_wavefront.py`` on its commit path
(``decode_shards_wavefront`` -> ``_decode_group`` ->
``_wavefront_batch(mode="commit")``):

1. **Speculative per-bit parse** (:func:`speculative_parse`, tensor ops):
   for every bit offset of every payload, decode the token that would start
   there: kind, count, index, and the next token's bit offset.  The JAX
   package does this bit math in uint32; here it is int64 with explicit
   32-bit masks.  It allocates about a dozen (S, NBP) int64 temporaries, a
   few GB at 8 shards of 1 MiB: memory traded for simplicity.
2. **Commit** (kernel B4, ops/decode_commit.py): one serial walk per shard
   from bit 0 along the parse chain, against a window ring.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    EXTENDED_MATCH_SYMBOL,
    EXTENDED_MATCH_TRAILING_BITS,
    FLUSH_SYMBOL,
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    RLE_SYMBOL,
    RLE_TRAILING_BITS,
    compute_min_pattern_size,
)
from ..device import resolve_device
from ..dictionary import dictionary_array
from ..exceptions import OutOfBoundsError
from .decode_commit import (
    ERR_OK, ERR_OOB, ERR_OVERFLOW, K_EXT, K_FLUSH, K_LIT, K_MATCH, K_RLE,
    commit_decode,
)

__all__ = ["decode_shards_wavefront", "payload_parse", "speculative_parse"]

_M32 = 0xFFFFFFFF
GROUP_PAYLOAD_BYTES = 1 << 23  # payload bytes parsed in one device group


def _bit_windows(pp: torch.Tensor, NBP: int):
    """(w0, w1): bits [b, b+32) and [b+32, b+64) of every bit offset b, as
    int64 holding uint32 values; ``pp`` is (S, L + 8) int64 payload bytes
    with >= 8 zero pad bytes."""
    L = NBP // 8
    V = ((pp[:, 0 : L + 4] << 24) | (pp[:, 1 : L + 5] << 16)
         | (pp[:, 2 : L + 6] << 8) | pp[:, 3 : L + 7])
    tail0 = pp[:, 4 : L + 4]   # byte just past w0's aligned word
    V4 = V[:, 4 : L + 4]       # aligned word 4 bytes later
    tail1 = pp[:, 8 : L + 8]
    w0_ph, w1_ph = [V[:, :L]], [V4]
    for r in range(1, 8):
        w0_ph.append(((V[:, :L] << r) & _M32) | (tail0 >> (8 - r)))
        w1_ph.append(((V4 << r) & _M32) | (tail1 >> (8 - r)))
    S = pp.shape[0]
    return (torch.stack(w0_ph, dim=2).reshape(S, NBP),
            torch.stack(w1_ph, dim=2).reshape(S, NBP))


def _field(w0, w1, k, m: int):
    """m (<= 16) bits at relative bit offset ``k`` (0..31) in (w0, w1)."""
    aligned = ((w0 << k) & _M32) | ((w1 >> 1) >> (31 - k))
    return aligned >> (32 - m)


def _decode_symbol(pk):
    """Symbol and code length (flag excluded) from an 8-bit peek; the code
    is complete, so exactly one codeword prefixes any peek."""
    s_out = torch.zeros_like(pk)
    n_out = torch.zeros_like(pk)
    for s in range(15):
        nb = HUFFMAN_LENGTHS[s] - 1
        hit = (pk >> (8 - nb)) == HUFFMAN_CODES[s]
        s_out = torch.where(hit, s, s_out)
        n_out = torch.where(hit, nb, n_out)
    return s_out, n_out


def speculative_parse(pp: torch.Tensor, nb_valid: torch.Tensor, NBP: int,
                      window: int, literal: int, extended: bool):
    """Per-bit token parse of S payloads: (nxt, kind, cnt, idx), each
    (S, NBP) int32.  ``nxt`` is the next token's bit offset, NBP where the
    token is incomplete (it ends past ``nb_valid`` (S,) bits, or starts at
    or past it)."""
    minp = compute_min_pattern_size(window, literal)
    w0, w1 = _bit_windows(pp, NBP)
    b = torch.arange(NBP, dtype=torch.int64, device=pp.device)[None, :]
    nbv = nb_valid.to(torch.int64)[:, None]

    flag = w0 >> 31
    lit_end = b + 1 + literal
    lit_val = _field(w0, w1, 1, literal)

    s1, n1 = _decode_symbol(_field(w0, w1, 1, 8))
    after1 = b + 1 + n1
    k_after1 = 1 + n1
    is_flush = s1 == FLUSH_SYMBOL
    if extended:
        is_rle = s1 == RLE_SYMBOL
        is_ext = s1 == EXTENDED_MATCH_SYMBOL
    else:
        is_rle = is_ext = torch.zeros_like(is_flush)

    s2, n2 = _decode_symbol(_field(w0, w1, k_after1, 8))
    after2 = after1 + n2
    k_after2 = k_after1 + n2

    rle_cnt = (s2 << RLE_TRAILING_BITS) + _field(
        w0, w1, k_after2, RLE_TRAILING_BITS) + 2
    rle_end = after2 + RLE_TRAILING_BITS
    ext_sz = ((s2 << EXTENDED_MATCH_TRAILING_BITS)
              + _field(w0, w1, k_after2, EXTENDED_MATCH_TRAILING_BITS)
              + minp + 12)
    ext_idx = _field(w0, w1, k_after2 + EXTENDED_MATCH_TRAILING_BITS, window)
    ext_end = after2 + EXTENDED_MATCH_TRAILING_BITS + window
    bm_idx = _field(w0, w1, k_after1, window)
    bm_end = after1 + window
    bm_sz = s1 + minp
    flush_end = ((after1 + 7) >> 3) << 3  # byte-align discard

    lit = flag == 1

    def pick(v_lit, v_flush, v_rle, v_ext, v_match):
        return torch.where(lit, v_lit, torch.where(
            is_flush, v_flush, torch.where(
                is_rle, v_rle, torch.where(is_ext, v_ext, v_match))))

    kind = pick(K_LIT, K_FLUSH, K_RLE, K_EXT, K_MATCH)
    end = pick(lit_end, flush_end, rle_end, ext_end, bm_end)
    cnt = pick(1, 0, rle_cnt, ext_sz, bm_sz)
    idx = pick(lit_val, bm_idx, 0, ext_idx, bm_idx)  # as the JAX parse
    incomplete = torch.where(is_flush, after1 > nbv, end > nbv) | (b >= nbv)
    nxt = torch.where(incomplete, NBP, end)
    return (nxt.to(torch.int32), kind.to(torch.int32), cnt.to(torch.int32),
            idx.to(torch.int32))


def _pow2_bucket(n: int, lo: int) -> int:
    """Next power of two >= max(n, lo)."""
    return 1 << max(n - 1, lo - 1, 1).bit_length()


def _raise_err(e: int) -> None:
    if e == ERR_OK:
        return
    if e == ERR_OOB:
        raise OutOfBoundsError("window reference out of bounds")
    if e == ERR_OVERFLOW:
        raise ValueError("decoded output exceeds max_out")
    raise ValueError("invalid tamp stream")


def payload_parse(payloads, *, window: int, literal: int, extended: bool,
                  device):
    """Per-bit parse of a group of header-less payloads on ``device``:
    (nxt, packed) (S, NBP) int32, ``packed = kind | cnt << 3 | idx << 11``,
    the input of the decode commit; NBP is 8x the power-of-two bucket of
    the longest payload."""
    S = len(payloads)
    L = _pow2_bucket(max(len(p) for p in payloads), 64)
    # the parse peeks up to ~22 bits past a start at bit 8L: pad 8 bytes
    blobs = np.zeros((S, L + 8), np.uint8)
    nbytes = np.zeros(S, np.int32)
    for i, p in enumerate(payloads):
        blobs[i, : len(p)] = np.frombuffer(p, np.uint8)
        nbytes[i] = len(p)
    pp = torch.from_numpy(blobs).to(device).to(torch.int64)
    nb = torch.from_numpy(nbytes).to(device)
    nxt, kind, cnt, idx = speculative_parse(pp, nb * 8, 8 * L, window,
                                            literal, extended)
    return nxt, kind | (cnt << 3) | (idx << 11)


def decode_group(payloads, *, window: int, literal: int, extended: bool,
                 more: bool, dict_init, dict_reset, max_out: int, device):
    """Parse + commit of one group of header-less payloads on ``device``:
    (out (S, max_out') uint8, lens (S,), errs (S,)) tensors, with
    max_out' the power-of-two bucket of ``max_out``."""
    nxt, packed = payload_parse(payloads, window=window, literal=literal,
                                extended=extended, device=device)
    di = torch.from_numpy(np.array(dict_init, np.uint8)).to(device)
    dr = torch.from_numpy(np.array(dict_reset, np.uint8)).to(device)
    return commit_decode(nxt, packed, di, dr, W=1 << window, more=more,
                         max_out=_pow2_bucket(max_out, 1024))


def decode_shards_wavefront(shards, *, dictionary=None, max_out: int,
                            device=None) -> list[bytes]:
    """Decode same-config Tamp streams (header included) on the card.

    All shards must share one header configuration (the TTPU container
    guarantees it); ``max_out`` bounds each shard's decoded size.  Shards are
    batched into groups of at most ``GROUP_PAYLOAD_BYTES`` payload bytes to
    cap the per-bit working set (~100 bytes of device memory per payload
    bit)."""
    dev = resolve_device(device)
    if not shards:
        return []
    h = shards[0][0]
    window = (h >> 5) + 8
    literal = ((h >> 3) & 3) + 5
    custom = (h >> 2) & 1
    extended = bool((h >> 1) & 1)
    more = bool(h & 1)
    skip = 2 if more else 1
    W = 1 << window
    default_dict = dictionary_array(W, literal=literal if extended else 8)
    if custom:
        if dictionary is None:
            raise ValueError("stream requires a custom dictionary")
        d = np.frombuffer(bytes(dictionary), np.uint8)
        if d.shape[0] < W:
            raise ValueError("dictionary smaller than the window")
        dict_init = d[:W]
    else:
        dict_init = default_dict

    payloads = []
    for s in shards:
        if s[0] != h:
            raise ValueError("shards must share one header configuration")
        if more and (len(s) < 2 or s[1] != 0):
            raise ValueError("reserved header byte must be zero")
        payloads.append(bytes(s[skip:]))

    groups: list[list[bytes]] = []
    i = 0
    while i < len(payloads):
        j = i + 1
        budget = len(payloads[i])
        while j < len(payloads) and budget + len(payloads[j]) \
                <= GROUP_PAYLOAD_BYTES:
            budget += len(payloads[j])
            j += 1
        groups.append(payloads[i:j])
        i = j

    out: list[bytes] = []
    for group in groups:
        if all(len(p) == 0 for p in group):
            out.extend(b"" for _ in group)
            continue
        outs, lens, errs = decode_group(
            group, window=window, literal=literal, extended=extended,
            more=more, dict_init=dict_init, dict_reset=default_dict,
            max_out=max_out, device=dev)
        errs = errs.cpu().numpy()
        lens = lens.cpu().numpy()
        for k in range(len(group)):
            _raise_err(int(errs[k]))
        blk = outs[:, : max(1, int(lens.max()))].cpu().numpy()
        out.extend(blk[k, : int(lens[k])].tobytes()
                   for k in range(len(group)))
    return out

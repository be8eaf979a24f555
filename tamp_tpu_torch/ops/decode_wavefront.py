"""Device decode of same-config Tamp streams: per-bit parse, then one of
three modes.

Counterpart of ``tamp_tpu/ops/decode_wavefront.py``
(``decode_shards_wavefront`` -> ``_decode_group`` -> ``_wavefront_batch``):

1. **Speculative per-bit parse** (:func:`speculative_parse`, tensor ops):
   for every bit offset of every payload, decode the token that would start
   there: kind, count, index, and the next token's bit offset.  The JAX
   package does this bit math in uint32; here it is int64 with explicit
   32-bit masks.  It allocates about a dozen (S, NBP) int64 temporaries, a
   few GB at 8 shards of 1 MiB: memory traded for simplicity.
2. One of three modes (``mode``, or ``TAMP_TPU_DECODE``; ``"commit"`` by
   default at every window):

   - ``commit``: kernel B4 (ops/decode_commit.py), one serial walk per
     shard along the parse chain against a window ring;
   - ``chase``: the token table by kernel B8 (ops/token_chase.py), then
     :func:`wavefront_finish`;
   - ``xla``: the token table by :func:`_token_table` (tensor ops), then
     :func:`wavefront_finish`.

   :func:`wavefront_finish` places every token's output, folds the window
   writes (kernel X1 for the serial truncation deficits), links each output
   byte to its source and resolves the links by pointer doubling.

A complete token never ends at bit NBP: the payload bucket holds one spare
byte past the longest payload (:func:`payload_parse`), so NBP marks only
incomplete tokens in every mode.
"""

from __future__ import annotations

import math
import os

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
from . import _build
from .decode_commit import (
    ERR_OK, ERR_OOB, ERR_OVERFLOW, K_EXT, K_FLUSH, K_LIT, K_MATCH, K_RLE,
    commit_decode,
)
from .token_chase import token_table_chase

__all__ = ["decode_shards_wavefront", "decode_group", "payload_groups",
           "payload_parse", "speculative_parse", "wavefront_finish",
           "fold_inputs", "trunc_deficits", "trunc_deficits_plain",
           "resolve_mode", "MODES"]

_M32 = 0xFFFFFFFF
GROUP_PAYLOAD_BYTES = 1 << 23  # payload bytes parsed in one device group
MODES = ("commit", "chase", "xla")
K_PAD = 5       # token-table slot past the last token
ERR_SEGKEY = 4  # too many double-FLUSH segments for the keyed search
I32MAX = 2**31 - 1
# The largest max_out of a decode: kernel B4 takes the power-of-two bucket
# of max_out as an int, so the bucket stays at most 2**30.  The payload's
# bit offsets are int32 too (nxt, B4's packed words): payload_parse
# refuses a bucket of 2**28 payload bytes (2**31 bits) or more.
MAX_OUT = 1 << 30
RLE_MAX_WINDOW_WRITE = 8
BLOCK_BITS = 256  # block of the xla token table; a token is <= 35 bits
ENTRY_SPAN = 64   # block-exit offsets are < 35: the entry offsets a map needs


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
    if e == ERR_SEGKEY:
        raise ValueError("stream exceeds wavefront segment budget")
    raise ValueError("invalid tamp stream")


def payload_parse(payloads, *, window: int, literal: int, extended: bool,
                  device):
    """Per-bit parse of a group of header-less payloads on ``device``:
    (nxt, packed) (S, NBP) int32, ``packed = kind | cnt << 3 | idx << 11``,
    the input of every decode mode.  NBP is 8x the power-of-two bucket of
    the longest payload plus one byte: with that spare byte no complete
    token ends at bit NBP, the value that marks an incomplete one (the JAX
    package buckets the bare length, and there a last token that ends on
    the bucket's last bit is dropped in its commit and chase modes)."""
    S = len(payloads)
    L = _pow2_bucket(max(len(p) for p in payloads) + 1, 64)
    if 8 * L > I32MAX:
        raise ValueError(
            f"a payload of {max(len(p) for p in payloads)} bytes is past the "
            "wavefront decode's int32 bit offsets")
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


def _token_table(nxt: torch.Tensor, NBP: int, literal: int, T_max: int):
    """Token starts (S, T_max) int32, zero past the last, and their count
    T (S,) int32: the orbit of ``nxt`` from bit 0, a bit whose ``nxt`` is
    NBP dropped as an incomplete trailing token.

    Counterpart of the JAX package's ``_token_table`` (there ``incomplete``
    is a separate plane; with the spare byte of :func:`payload_parse` it is
    ``nxt == NBP``), batched over shards, in four stages:

    1. pointer doubling gives each bit its block exit, the first orbit
       position past its 256-bit block (as JAX);
    2. the block entries, the orbit's first position in each block: the JAX
       package chains them with a serial ``lax.scan`` over the blocks; here
       they come from a log-depth prefix composition of the per-block exit
       maps (Hillis-Steele, ceil(log2(nblk)) gathers).  An exit is less
       than 35 bits past its block's end, so each map needs only the entry
       offsets 0..ENTRY_SPAN-1 and a sentinel for an ended orbit;
    3. a lockstep walk over all blocks (as JAX) marks each block's tokens;
    4. a prefix sum over the marks compacts them into the table.
    """
    S = nxt.shape[0]
    dev = nxt.device
    B = BLOCK_BITS
    nblk = NBP // B
    nx = nxt.to(torch.int64)
    b = torch.arange(NBP, device=dev)
    pos_end = ((b // B) + 1) * B
    ex = nx
    for _ in range(math.ceil(math.log2(B // (1 + literal) + 2))):
        hop = ex.gather(1, ex.clamp(0, NBP - 1))
        ex = torch.where(ex < pos_end, hop, ex)

    D = ENTRY_SPAN
    blk = torch.arange(nblk, device=dev)
    ex_in = ex.view(S, nblk, B)[:, :, :D]
    # the clamp only keeps a malformed plane's gathers in range
    F = torch.where(ex_in >= NBP, D,
                    (ex_in - ((blk + 1) * B)[None, :, None]).clamp(0, D))
    F = torch.cat([F, torch.full((S, nblk, 1), D, device=dev)], dim=2)
    shift = 1
    while shift < nblk:  # F[k] becomes F[k] o ... o F[0]
        F = torch.cat([F[:, :shift], F[:, shift:].gather(2, F[:, :-shift])],
                      dim=1)
        shift *= 2
    off = torch.cat([torch.zeros((S, 1), dtype=torch.int64, device=dev),
                     F[:, :-1, 0]], dim=1)
    c = torch.where(off >= D, NBP, blk * B + off)

    lim = (blk + 1) * B
    mark = torch.zeros((S, NBP + 1), dtype=torch.bool, device=dev)
    for _ in range(B // (1 + literal) + 2):
        in_blk = c < lim
        n = nx.gather(1, c.clamp_max(NBP - 1))
        mark.scatter_(1, torch.where(in_blk & (n < NBP), c, NBP), True)
        c = torch.where(in_blk, n, c)
    mark = mark[:, :NBP]
    T = mark.sum(1)
    slot = torch.where(mark, torch.cumsum(mark, 1) - 1, T_max)
    starts = torch.zeros((S, T_max + 1), dtype=torch.int64, device=dev)
    starts.scatter_(1, slot.clamp_max(T_max), b.expand(S, NBP))
    return starts[:, :T_max].to(torch.int32), T.to(torch.int32)


def _seg_base(values: torch.Tensor, resets: torch.Tensor, seg: torch.Tensor):
    """Per-token segment-relative values (S, T_max): ``values`` (a global
    exclusive prefix sum) less its value at the segment's first token (the
    reset FLUSH).  Counterpart of the JAX package's ``_seg_base``."""
    n = values.shape[1]
    base = torch.zeros((values.shape[0], n + 1), dtype=values.dtype,
                       device=values.device)
    base.scatter_(1, torch.where(resets, seg, n), values)
    return values - base.gather(1, seg.clamp_max(n - 1))


def trunc_deficits_plain(seg_c, s_c, w_c, n_tr, W: int):
    """X1 as a Python loop per shard (on host copies of the inputs); the
    result is returned on the inputs' device."""
    S, T_max = seg_c.shape
    sg_h, s_h, w_h = (x.cpu().numpy() for x in (seg_c, s_c, w_c))
    n_h = n_tr.cpu().numpy()
    defs = np.zeros((S, T_max), np.int32)
    for s in range(S):
        D = cur = 0
        for i in range(int(n_h[s])):
            sg = int(sg_h[s, i])
            if sg != cur:
                D = 0
            room = W - ((int(s_h[s, i]) - D) % W)
            d = max(0, int(w_h[s, i]) - room)
            D += d
            cur = sg
            defs[s, i] = d
    return torch.from_numpy(defs).to(seg_c.device)


def trunc_deficits(seg_c, s_c, w_c, n_tr, W: int):
    """Window-write truncation deficits of the truncating tokens (RLE and
    extended matches) of each shard, compacted: ``defs_c`` (S, T_max)
    int32 from their segment ids ``seg_c``, segment-relative untruncated
    write offsets ``s_c`` and untruncated write counts ``w_c`` (all (S,
    T_max) int32, valid below ``n_tr`` (S,)).  Counterpart of the
    ``tr_body`` while_loop of the JAX package's ``_wavefront_finish``:
    kernel X1 for CUDA tensors, the plain version for CPU tensors."""
    for x in (seg_c, s_c, w_c):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape != seg_c.shape:
            raise ValueError("seg_c, s_c and w_c must be (S, T_max) int32")
    if n_tr.dtype != torch.int32 or n_tr.shape != seg_c.shape[:1]:
        raise ValueError("n_tr must be an (S,) int32 tensor")
    if seg_c.device.type == "cpu":
        return trunc_deficits_plain(seg_c, s_c, w_c, n_tr, W)
    if seg_c.device.type != "cuda":
        raise ValueError(f"unsupported device {seg_c.device}")
    S, T_max = seg_c.shape
    defs = torch.zeros((S, T_max), dtype=torch.int32, device=seg_c.device)
    _build.launch("decode_wavefront", "tpt_trunc_deficits", seg_c.device,
                  (seg_c.contiguous(), s_c.contiguous(), w_c.contiguous(),
                   n_tr.contiguous(), defs), (S, T_max, W))
    trunc_deficits.launches += 1
    return defs


trunc_deficits.launches = 0


def _tokens(starts, T, packed, more: bool):
    """Token arrays (S, T_max) int64 from the token table: (active, kind,
    count, index, resets, seg); a slot past T is K_PAD with count 0, and a
    double FLUSH (``more`` streams) starts a segment."""
    T_max = starts.shape[1]
    tid = torch.arange(T_max, device=starts.device)
    active = tid[None, :] < T.to(torch.int64)[:, None]
    pk = packed.gather(1, starts.to(torch.int64)).to(torch.int64)
    tk = torch.where(active, pk & 7, K_PAD)
    tcnt = torch.where(active, (pk >> 3) & 0xFF, 0)
    tidx = torch.where(active, pk >> 11, 0)
    fl = tk == K_FLUSH
    if more:
        resets = fl & torch.nn.functional.pad(fl[:, :-1], (1, 0))
    else:
        resets = torch.zeros_like(fl)
    return active, tk, tcnt, tidx, resets, torch.cumsum(resets, 1)


def _fold_terms(tk, tcnt, resets, seg):
    """The untruncated window-write counts ``w_unc``, their segment-relative
    exclusive sums ``S_seg``, the truncating tokens' ids ``tr_tok`` (compact,
    ``n_tr`` of them per shard) and the inputs of :func:`trunc_deficits`."""
    S, T_max = tk.shape
    w_unc = torch.where(tk == K_LIT, 1, torch.where(
        tk == K_MATCH, tcnt, torch.where(
            tk == K_RLE, tcnt.clamp_max(RLE_MAX_WINDOW_WRITE), torch.where(
                tk == K_EXT, tcnt, 0))))
    S_seg = _seg_base(torch.cumsum(w_unc, 1) - w_unc, resets, seg)
    trunc = (tk == K_RLE) | (tk == K_EXT)
    n_tr = trunc.sum(1)
    tr_tok = torch.zeros((S, T_max + 1), dtype=torch.int64, device=tk.device)
    tr_tok.scatter_(1, torch.where(trunc, torch.cumsum(trunc, 1) - 1, T_max),
                    torch.arange(T_max, device=tk.device).expand(S, T_max))
    tr_tok = tr_tok[:, :T_max]
    i32 = torch.int32
    x1_in = (seg.gather(1, tr_tok).to(i32), S_seg.gather(1, tr_tok).to(i32),
             w_unc.gather(1, tr_tok).to(i32), n_tr.to(i32))
    return w_unc, S_seg, tr_tok, n_tr, x1_in


def fold_inputs(starts, T, packed, *, more: bool):
    """The inputs of kernel X1 (``seg_c, s_c, w_c, n_tr``) for a token
    table, as :func:`wavefront_finish` builds them."""
    _a, tk, tcnt, _i, resets, seg = _tokens(starts, T, packed, more)
    return _fold_terms(tk, tcnt, resets, seg)[4]


def wavefront_finish(starts, T, packed, dict_init, dict_reset, *,
                     window: int, more: bool, max_out: int):
    """The stages after boundary resolution, batched over shards: (out
    (S, max_out) uint8, lens (S,) int32, errs (S,) int32).

    Counterpart of the JAX package's ``_wavefront_finish`` (vmapped), with
    the same results, errors included: token gather from the token table
    ``starts``/``T`` and the parse words ``packed``; OOB check; double-FLUSH
    segments (``more`` streams); placement by prefix sum; the window-write
    fold (untruncated prefix sums, then the truncation deficits by
    :func:`trunc_deficits`); per-output-byte source links; pointer doubling.
    The arithmetic is int64 (JAX's is int32; no valid stream overflows it).
    JAX's ``mode="drop"`` scatters go to one spare slot past the end; its
    early exit of the pointer doubling is a fixed round count here, which
    gives the same result.  The keyed search on ``more`` streams is a
    row-wise ``searchsorted``; where the output overflows, its keys are not
    sorted and the bytes may differ from JAX's, but the error is the same.
    """
    S, T_max = starts.shape
    dev = starts.device
    W = 1 << window
    tid = torch.arange(T_max, device=dev)
    tids = tid.expand(S, T_max)
    active, tk, tcnt, tidx, resets, seg = _tokens(starts, T, packed, more)

    err = torch.zeros(S, dtype=torch.int64, device=dev)
    is_m = (tk == K_MATCH) | (tk == K_EXT)
    err = torch.where((is_m & (tidx + tcnt > W)).any(1), ERR_OOB, err)

    cs_cnt = torch.cumsum(tcnt, 1)
    out_start = cs_cnt - tcnt
    out_len = cs_cnt[:, -1]
    err = torch.where((err == ERR_OK) & (out_len > max_out), ERR_OVERFLOW,
                      err)
    out_len = out_len.clamp_max(max_out)

    # window-write fold: untruncated sums, then the truncation deficits
    w_unc, S_seg, tr_tok, n_tr, x1_in = _fold_terms(tk, tcnt, resets, seg)
    defs_c = trunc_deficits(*x1_in, W)
    defs = torch.zeros((S, T_max + 1), dtype=torch.int64, device=dev)
    defs.scatter_(1, torch.where(tid[None, :] < n_tr[:, None], tr_tok, T_max),
                  defs_c.to(torch.int64))
    defs = defs[:, :T_max]
    D_seg = _seg_base(torch.cumsum(defs, 1) - defs, resets, seg)
    A = W + S_seg - D_seg  # write-stream position before each token

    # per-output-byte source links
    obyte = torch.arange(max_out, device=dev)
    valid_b = obyte[None, :] < out_len[:, None]
    tok_of = torch.zeros((S, max_out + 1), dtype=torch.int64, device=dev)
    tok_of.scatter_reduce_(
        1, torch.where(active, out_start, max_out).clamp_max(max_out), tids,
        reduce="amax")
    tok_of = torch.cummax(tok_of[:, :max_out], 1).values
    off = obyte[None, :] - out_start.gather(1, tok_of)
    kb = tk.gather(1, tok_of)
    tix = tidx.gather(1, tok_of)
    src = torch.where(kb == K_LIT, -(tix + 1), 0)
    rle_b = kb == K_RLE
    m_b = (kb == K_MATCH) | (kb == K_EXT)
    Am1 = A.gather(1, tok_of) - 1
    a = torch.where(rle_b, Am1, torch.where(
        m_b, Am1 - torch.remainder(Am1 - (tix + off), W), 0))
    need = rle_b | m_b
    seg_of = seg.gather(1, tok_of)
    a_dict = a.clamp(0, W - 1)
    dict_val = torch.where(seg_of == 0, dict_init.to(torch.int64)[a_dict],
                           dict_reset.to(torch.int64)[a_dict])
    src = torch.where(need & (a < W), -(dict_val + 1), src)

    from_out = need & (a >= W)
    if not more:
        # one segment: the write stream [W, W + out_len) is dense, so the
        # owning token (max id with A <= a) is a scatter and a running max
        DOM = W + max_out
        ownmap = torch.zeros((S, DOM + 1), dtype=torch.int64, device=dev)
        ownmap.scatter_reduce_(
            1, torch.where(active, A.clamp_max(DOM), DOM), tids,
            reduce="amax")
        ownmap = torch.cummax(ownmap[:, :DOM], 1).values
        own = ownmap.gather(1, a.clamp(0, DOM - 1))
    else:
        # keyed (per-segment) monotone write positions; the budget test is
        # JAX's float32 one, so the same streams fail it
        BIG = W + max_out + 2
        n_seg = seg[:, -1] + 1
        over = (n_seg.to(torch.float32) + 1.0) * float(BIG) >= 2.0**31
        err = torch.where((err == ERR_OK) & over, ERR_SEGKEY, err)
        A_key = torch.where(active, A + seg * BIG, I32MAX)
        a_key = torch.where(from_out, a + seg_of * BIG, 0)
        own = torch.searchsorted(A_key, a_key, right=True) - 1
        own = own.clamp(0, T_max - 1)
    src = torch.where(from_out,
                      out_start.gather(1, own) + (a - A.gather(1, own)), src)

    # pointer-doubling value resolution: JAX's round bound, no early exit
    for _ in range(max(1, math.ceil(math.log2(max(max_out, 2))) + 1)):
        src = torch.where(src >= 0, src.gather(1, src.clamp(0, max_out - 1)),
                          src)
    out = torch.where(valid_b, -src - 1, 0) & 0xFF
    return out.to(torch.uint8), out_len.to(torch.int32), err.to(torch.int32)


def resolve_mode(mode=None) -> str:
    """The decode mode: ``mode`` itself (one of MODES), or for None the
    ``TAMP_TPU_DECODE`` environment variable where it names a mode, else
    ``"commit"`` at every window (B4 has no ring-size limit on the card)."""
    if mode is None:
        env = os.environ.get("TAMP_TPU_DECODE")
        return env if env in MODES else "commit"
    if mode not in MODES:
        raise ValueError(f"unknown decode mode {mode!r}: one of {MODES}")
    return mode


def decode_group(payloads, *, window: int, literal: int, extended: bool,
                 more: bool, dict_init, dict_reset, max_out: int, device,
                 mode: str = "commit"):
    """Parse + decode of one group of header-less payloads on ``device`` in
    ``mode``: (out (S, max_out') uint8, lens (S,), errs (S,)) tensors, with
    max_out' the power-of-two bucket of ``max_out``."""
    mode = resolve_mode(mode)
    nxt, packed = payload_parse(payloads, window=window, literal=literal,
                                extended=extended, device=device)
    di = torch.from_numpy(np.array(dict_init, np.uint8)).to(device)
    dr = torch.from_numpy(np.array(dict_reset, np.uint8)).to(device)
    max_out = _pow2_bucket(max_out, 1024)
    if mode == "commit":
        return commit_decode(nxt, packed, di, dr, W=1 << window, more=more,
                             max_out=max_out)
    NBP = nxt.shape[1]
    T_max = NBP // (1 + literal) + 2
    if mode == "chase":
        starts, T = token_table_chase(nxt, NBP, T_max)
    else:
        starts, T = _token_table(nxt, NBP, literal, T_max)
    del nxt
    return wavefront_finish(starts, T, packed, di, dr, window=window,
                            more=more, max_out=max_out)


def split_streams(shards, dictionary):
    """The header configuration that same-config Tamp streams share and
    their header-less payloads: (window, literal, extended, more,
    dict_init, default_dict, payloads).  ``dict_init`` is the first W bytes
    of ``dictionary`` for a custom-dictionary stream (which must fill the
    window), else the default dictionary, which is also what a double FLUSH
    resets the window to."""
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
    return window, literal, extended, more, dict_init, default_dict, payloads


def payload_groups(payloads) -> list[tuple[int, int]]:
    """Index ranges ``[i, j)`` of consecutive payloads, each group at most
    ``GROUP_PAYLOAD_BYTES`` payload bytes (a longer payload alone), which
    caps the per-bit working set (~100 bytes of device memory per payload
    bit)."""
    groups = []
    i = 0
    while i < len(payloads):
        j = i + 1
        budget = len(payloads[i])
        while j < len(payloads) and budget + len(payloads[j]) \
                <= GROUP_PAYLOAD_BYTES:
            budget += len(payloads[j])
            j += 1
        groups.append((i, j))
        i = j
    return groups


def decode_shards_wavefront(shards, *, dictionary=None, max_out: int,
                            device=None, mode: str | None = None
                            ) -> list[bytes]:
    """Decode same-config Tamp streams (header included) on the card.

    All shards must share one header configuration (the TTPU container
    guarantees it); ``max_out`` bounds each shard's decoded size.  ``mode``
    is ``"commit"``, ``"chase"`` or ``"xla"`` (see the module docstring);
    None takes ``TAMP_TPU_DECODE`` where it names a mode, else ``"commit"``.
    Shards are decoded in the groups of :func:`payload_groups`."""
    mode = resolve_mode(mode)
    dev = resolve_device(device)
    if not shards:
        return []
    (window, literal, extended, more, dict_init, default_dict,
     payloads) = split_streams(shards, dictionary)

    out: list[bytes] = []
    for i, j in payload_groups(payloads):
        group = payloads[i:j]
        if all(len(p) == 0 for p in group):
            out.extend(b"" for _ in group)
            continue
        outs, lens, errs = decode_group(
            group, window=window, literal=literal, extended=extended,
            more=more, dict_init=dict_init, dict_reset=default_dict,
            max_out=max_out, device=dev, mode=mode)
        errs = errs.cpu().numpy()
        lens = lens.cpu().numpy()
        for k in range(len(group)):
            _raise_err(int(errs[k]))
        blk = outs[:, : max(1, int(lens.max()))].cpu().numpy()
        out.extend(blk[k, : int(lens[k])].tobytes()
                   for k in range(len(group)))
    return out

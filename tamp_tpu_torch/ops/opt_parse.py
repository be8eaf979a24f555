"""Optimal (minimum-bit) v1 parse on the card (kernel X3) and its plain
version.

Counterpart of ``tamp_tpu/ops/opt_parse.py::opt_v1_choice_device``.  The
DP is a backward recurrence with bounded lookback: ``cost[p]`` depends on
``cost[p+1 .. p+K]`` (K = 16: a literal advances 1, a match ``minp`` to
``minp + 13 <= 16``).  Over the (min, +) semiring it is linear, so it runs
in three passes over blocks of B positions:

  pass 1   each block's K x K min-plus transfer matrix: the identity pushed
           through the block's B positions, right to left;
  combine  the boundary vectors of the blocks, right to left (one matrix
           by vector product a block; the kernel's two-level form: the
           products of groups of G_V1 blocks, a pass over the groups, then
           the blocks of each group);
  pass 2   the exact costs inside each block from its boundary vector, and
           each position's choice: the lowest advance among the minimal
           costs (literal first, then ascending match size), which is the
           native DP's tie-break (``score = cost * 32 + priority`` in the
           JAX function).

Every sum saturates at ``INF``; with non-negative weights the saturation
commutes with min-plus, so the outputs do not depend on B and products of
block matrices associate.  The combine keeps each boundary vector less its
least entry (INF entries stay INF): min-plus commutes with that shift, and
the choice and ``bad`` do not see it, so costs stay relative to a few
blocks and a shard of any length never reaches INF (the JAX function
instead refuses shards whose whole cost could); ``cost0`` adds the shifts
back, saturated at INF.  Positions at or past a shard's length are free
literals (cost 0); in-shard matches never reach past it because the tables
stop at ``npos``.

:func:`opt_v1_choice_plain` runs the three passes in tensor ops with the
JAX function's arithmetic; :func:`opt_v1_choice` launches the CUDA kernels
(``csrc/opt_parse.cu``, entry ``tpt_opt_v1_choice``: pass 1, the combine's
three launches, pass 2) for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..constants import HUFFMAN_LENGTHS, compute_min_pattern_size
from . import _build

__all__ = ["opt_v1_choice", "opt_v1_choice_plain", "INF", "K_V1", "G_V1",
           "block_size", "v1_block"]

# Saturating infinity: above every cost relative to a boundary vector's
# least entry, and with INF * 32 + priority inside int32 (pass 2's packed
# score)
INF = (1 << 26) - 64
K_V1 = 16        # the v1 lookback: literal 1, matches minp..minp + 13
B_V1 = 512       # positions a block of X3's kernels
G_V1 = 32        # blocks a group of X3's combine (G in csrc/opt_parse.cu)


def block_size(NP: int, B: int) -> int:
    """``min(B, NP)``, which must divide NP."""
    B = min(B, NP)
    if B < 1 or NP % B:
        raise ValueError(f"NP={NP} must be a multiple of the block size {B}")
    return B


def v1_block(NP: int) -> int:
    """X3's block size for NP positions: the largest power of two that
    divides NP, at most B_V1."""
    return math.gcd(NP, B_V1)


def to_steps(x: torch.Tensor, n_b: int, B: int) -> torch.Tensor:
    """(S, NP) -> (B, S, n_b): step k holds in-block offset B - 1 - k."""
    S = x.shape[0]
    return x.reshape(S, n_b, B).permute(2, 0, 1).flip(0)


def from_steps(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_steps`."""
    B, S, n_b = x.shape
    return x.flip(0).permute(1, 2, 0).reshape(S, n_b * B)


def _apply(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Min-plus matrix (S, K, K) by vector (S, K), saturated at INF."""
    return torch.clamp_max((T + v[:, None, :]).amin(2), INF)


def rebase(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(v less its least entry, that entry): a vector (S, K) of saturated
    costs shifted so its least entry is 0, INF entries kept INF (and a
    vector of INF left as it is, with shift 0)."""
    m = v.amin(1, keepdim=True)
    m = torch.where(m < INF, m, 0)
    return torch.where(v >= INF, INF, v - m), m[:, 0]


def combine_plain(T: torch.Tensor, group: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bounds (S, n_b, K), v0 (S, K)) of transfer matrices T (S, n_b, K,
    K): block b's incoming boundary vector (the costs of the first K
    positions of block b + 1, zeros past the last block), less its least
    entry (:func:`rebase`), and the shard's first K costs, saturated at
    INF.

    ``group=None`` walks the blocks right to left.  ``group=G`` is the
    kernel's two-level form, with the same result: the product of each
    group of G consecutive blocks (the last group may be short), a right
    to left pass over the groups' products that gives each group's
    incoming vector (the bounds of its last block), then each group's
    blocks from that vector."""
    S, n_b, K, _ = T.shape
    v = torch.zeros((S, K), dtype=torch.int32, device=T.device)
    off = torch.zeros(S, dtype=torch.int64, device=T.device)
    bounds = torch.empty((S, n_b, K), dtype=torch.int32, device=T.device)

    def absolute(v):
        return torch.clamp_max(v + off[:, None], INF).to(torch.int32)

    if group is None:
        for b in range(n_b - 1, -1, -1):
            v, m = rebase(v)
            off += m
            bounds[:, b] = v
            v = _apply(T[:, b], v)
        return bounds, absolute(v)
    spans = [(b0, min(b0 + group, n_b) - 1) for b0 in range(0, n_b, group)]
    prods = []
    for b0, last in spans:
        acc = T[:, last]
        for b in range(last - 1, b0 - 1, -1):
            acc = torch.clamp_max(
                (T[:, b, :, :, None] + acc[:, None, :, :]).amin(2), INF)
        prods.append(acc)
    for (_b0, last), acc in zip(reversed(spans), reversed(prods)):
        v, m = rebase(v)
        off += m
        bounds[:, last] = v
        v = _apply(acc, v)
    for b0, last in spans:
        w = bounds[:, last]
        for b in range(last, b0, -1):
            w = rebase(_apply(T[:, b], w))[0]
            bounds[:, b - 1] = w
    return bounds, absolute(v)


def identity(S: int, n_b: int, K: int, device) -> torch.Tensor:
    """The (S, n_b, K, K) min-plus identity: 0 on the diagonal, INF off."""
    eye = torch.full((K, K), INF, dtype=torch.int32, device=device)
    eye.fill_diagonal_(0)
    return eye.expand(S, n_b, K, K).clone()


def opt_v1_choice_plain(flen: torch.Tensor, data: torch.Tensor,
                        npos: torch.Tensor, *, window: int, literal: int,
                        B: int | None = None, group: int | None = None):
    """X3 in tensor ops on the inputs' device: (choice (S, NP) int32,
    cost0 (S,) int32, bad (S,) bool), with B positions a block (the
    kernel's, :func:`v1_block`, by default) and the combine of
    :func:`combine_plain` (``group``)."""
    S, NP = flen.shape
    dev = flen.device
    B = v1_block(NP) if B is None else block_size(NP, B)
    n_b = NP // B
    K = K_V1
    minp = compute_min_pattern_size(window, literal)
    maxpat = minp + 13
    lit_limit = 256 if literal == 8 else (1 << literal)
    i32 = dict(dtype=torch.int32, device=dev)
    inf = torch.tensor(INF, **i32)

    in_shard = (torch.arange(NP, device=dev)[None, :]
                < npos.to(dev, torch.int64)[:, None])
    di = data.to(torch.int32)
    zero = torch.zeros((), **i32)
    # free-literal padding: cost 0, always valid -> cost[p >= npos] == 0
    lit_cost = torch.where(in_shard, torch.where(
        di < lit_limit, torch.tensor(1 + literal, **i32), inf), zero)
    cap = torch.where(in_shard, torch.clamp_max(flen.to(torch.int32),
                                                maxpat), zero)
    lit_s = to_steps(lit_cost, n_b, B)
    cap_s = to_steps(cap, n_b, B)
    ins_s = to_steps(in_shard, n_b, B)
    match_bits = {s: torch.tensor(HUFFMAN_LENGTHS[s - minp] + window, **i32)
                  for s in range(minp, maxpat + 1)}

    # pass 1: block transfer matrices (rows: cost[p+1+r], columns: the
    # boundary vector's entries)
    M = identity(S, n_b, K, dev)
    for k in range(B):
        lc, cp = lit_s[k], cap_s[k]
        new = torch.clamp_max(M[:, :, 0] + lc[:, :, None], INF)
        for s in range(minp, maxpat + 1):
            cs = torch.where(cp >= s, match_bits[s], inf)
            new = torch.minimum(new, M[:, :, s - 1] + cs[:, :, None])
        new = torch.clamp_max(new, INF)
        M = torch.cat([new[:, :, None], M[:, :, : K - 1]], dim=2)

    bounds, v0 = combine_plain(M, group)

    # pass 2: concrete costs and the tie-broken choice
    cur = bounds
    bad = torch.zeros((S, n_b), dtype=torch.bool, device=dev)
    ch = torch.empty((B, S, n_b), **i32)
    for k in range(B):
        lc, cp = lit_s[k], cap_s[k]
        best = torch.clamp_max(cur[:, :, 0] + lc, INF) * 32
        for s in range(minp, maxpat + 1):
            cs = torch.where(cp >= s, match_bits[s], inf)
            sc = (torch.clamp_max(cur[:, :, s - 1] + cs, INF) * 32
                  + (s - minp + 1))
            best = torch.minimum(best, sc)
        cost = torch.clamp_max(best >> 5, INF)
        pri = best & 31
        ch[k] = torch.where(pri == 0, 1, pri - 1 + minp)
        bad |= ins_s[k] & (cost >= INF)
        cur = torch.cat([cost[:, :, None], cur[:, :, : K - 1]], dim=2)
    return from_steps(ch), v0[:, 0].contiguous(), bad.any(dim=1)


def opt_v1_choice(flen: torch.Tensor, data: torch.Tensor, npos: torch.Tensor,
                  *, window: int, literal: int):
    """(choice (S, NP) int32, cost0 (S,) int32, bad (S,) bool) of the
    optimal v1 parse: kernel X3 for CUDA tensors, the plain version for
    CPU tensors.

    ``flen``: (S, NP) int32 match lengths at cap ``min(16, minp + 13)``
    (kernel B5's, exact up to ``npos``); ``data``: (S, NP) uint8 shard
    bytes; ``npos``: (S,) int32 lengths.  ``choice`` is 1 for a literal
    and s for a match of size s at every position; ``cost0`` is each
    shard's payload bits, saturated at INF (INF also where the shard's
    first byte cannot be coded); ``bad`` is True where any in-shard
    position has no valid token."""
    if flen.dtype != torch.int32 or flen.dim() != 2:
        raise ValueError("flen must be an (S, NP) int32 tensor")
    if data.dtype != torch.uint8 or data.shape != flen.shape:
        raise ValueError("data must be an (S, NP) uint8 tensor")
    if npos.dtype != torch.int32 or npos.shape != flen.shape[:1]:
        raise ValueError("npos must be an (S,) int32 tensor")
    if not (flen.device == data.device == npos.device):
        raise ValueError("flen, data and npos must share one device")
    if flen.device.type == "cpu":
        return opt_v1_choice_plain(flen, data, npos, window=window,
                                   literal=literal)
    if flen.device.type != "cuda":
        raise ValueError(f"unsupported device {flen.device}")
    S, NP = flen.shape
    B = v1_block(NP)
    if B % K_V1:
        raise ValueError(f"NP={NP} must be a multiple of {K_V1}")
    data = data.contiguous()
    if data.data_ptr() % 4:  # the kernel stages the bytes four at a time
        data = data.clone()
    choice, cost0, bad = launch_dp(
        "tpt_opt_v1_choice", flen.device, S, NP, B, K_V1, torch.int32,
        (flen.contiguous(), data, npos.contiguous()), window, literal)
    opt_v1_choice.launches += 1
    return choice, cost0, bad


opt_v1_choice.launches = 0


def launch_dp(entry: str, dev, S: int, NP: int, B: int, K: int,
              choice_dtype, inputs, window: int, literal: int):
    """Run the C entry ``entry`` of ``csrc/opt_parse.cu`` (the three passes
    of X3 or X4) on ``inputs``; returns (choice, cost0, bad).  The
    transfer matrices (a K x K block of ints, padded to a multiple of four,
    per block) and the boundary vectors are scratch from torch's
    allocator."""
    n_b = NP // B
    ts = (K * K + 3) & ~3
    choice = torch.empty((S, NP), dtype=choice_dtype, device=dev)
    cost0 = torch.empty(S, dtype=torch.int32, device=dev)
    bad = torch.zeros(S, dtype=torch.int32, device=dev)
    T = torch.empty(S * n_b * ts, dtype=torch.int32, device=dev)
    bounds = torch.empty(S * n_b * K, dtype=torch.int32, device=dev)
    _build.launch("opt_parse", entry, dev,
                  (*inputs, choice, cost0, bad, T, bounds),
                  (S, NP, B, window, literal))
    return choice, cost0, bad != 0

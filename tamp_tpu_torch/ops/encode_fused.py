"""Fused v1 encode of a batch of shards on the card: search, pack, commit.

Counterpart of ``tamp_tpu/ops/encode_fused.py::encode_v1_fused_dev``.  The
raw shard bytes and the window dictionary are the only inputs; the
compressed bytes and a 16-int state row per shard the only outputs:

  1. kernel B5 (ops/match_v1.py): the v1 tables at cap ``min(16, minp +
     13)`` on ``C = dict || data`` with the targets stopping at npos (the
     kernel reads the rows and the dictionary in place; the plain version
     builds the ``-1``-padded C and the ``0x1FF``-padded targets), plus the
     probe family under lazy matching;
  2. pack ``len << 23 | idx << 8 | byte`` (and ``plen << 15 | pidx``);
  3. commit: without lazy matching the v1 field planner and kernel B3
     (ops/encode_commit.py), with it kernel B6.
"""

from __future__ import annotations

import torch

from ..constants import compute_min_pattern_size
from .encode_commit import commit_fields, commit_v1_lazy, plan_fields_v1
from .match_v1 import v1_tables

__all__ = ["encode_v1_fused", "v1_cap"]


def v1_cap(window: int, literal: int) -> int:
    """The table cap the v1 walk reads: min(16, minp + 13), 15 or 16."""
    return min(16, compute_min_pattern_size(window, literal) + 13)


def encode_v1_fused(data: torch.Tensor, npos: torch.Tensor,
                    dict_arr: torch.Tensor, *, window: int, literal: int,
                    lazy: bool, max_out: int):
    """Fused v1 encode of S shards: (bytes (S, max_out) uint8, state (S, 16)
    int32) as ops/encode_commit.py returns them.

    ``data``: (S, NP) uint8 (zero-padded); ``npos``: (S,) int32 lengths;
    ``dict_arr``: (W,) uint8 initial window."""
    tabs = v1_tables(data, npos, dict_arr, window_bits=window,
                     cap=v1_cap(window, literal), probe=lazy)
    packed = (tabs[0] << 23) | (tabs[1] << 8) | data.to(torch.int32)
    if lazy:
        probe = (tabs[2] << 15) | tabs[3]
        return commit_v1_lazy(packed, probe, npos, window=window,
                              literal=literal, max_out=max_out)
    A, B = plan_fields_v1(packed, window=window, literal=literal)
    return commit_fields(A, B, npos, max_out=max_out)

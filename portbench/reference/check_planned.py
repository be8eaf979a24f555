"""What decides ``correct`` in a cell of the planned extended encode: the
encode check of :mod:`.check` with the plain planned encoder
(:mod:`.tamp_planned`) in the greedy encoder's place.  For each kept
container:

- ``frame_faults``: the frame does not parse, or its version is not 2, or
  its raw size, shard size or shard count is not the input's;
- then on a sample of ``sample`` shards drawn from the seed:
  ``streams_unequal``, the shards whose stream is not the plain planned
  encoder's, and ``bytes_wrong``, the bytes of the reference decoder's
  output of the program's stream that differ from the input shard (with
  the length difference).

Every number is exact, so every limit is 0.  The reference runs after the
window, its shards spread over processes.
"""

from __future__ import annotations

import random

from . import tamp_plain as T
from . import tamp_planned
from .check import _map, _shards, diff

__all__ = ["check_encode_planned"]


def _job(job) -> tuple[int, int]:
    shard, stream, window, literal = job
    ref = tamp_planned.encode(shard, window=window, literal=literal)
    try:
        wrong = diff(T.decode(stream), shard)
    except ValueError:
        wrong = len(shard)
    return int(ref != stream), wrong


def check_encode_planned(items, *, window: int, literal: int,
                         shard_bytes: int, sample: int, seed: int) -> dict:
    """``{name: (value, limit)}`` of ``(input, container)`` pairs."""
    faults, pairs = _shards(items, shard_bytes)
    pick = random.Random(seed).sample(pairs, min(sample, len(pairs)))
    res = _map(_job, [(raw, s, window, literal) for raw, s in pick])
    return {"frame_faults": (faults, 0),
            "streams_unequal": (sum(r[0] for r in res), 0),
            "bytes_wrong": (sum(r[1] for r in res), 0)}

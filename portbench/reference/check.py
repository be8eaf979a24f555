"""What decides ``correct``: the results kept from a run's window, judged by
the plain reference (:mod:`portbench.reference.tamp_plain`) and by the
inputs the benchmark made.  Every number is exact, so every limit is 0.

Encode cells (:func:`check_encode`), for each kept container:

- ``frame_faults``: the frame does not parse, or its version is not 2, or
  its raw size, shard size or shard count is not the input's;
- then on a sample of ``sample`` shards drawn from the seed:
  ``streams_unequal``, the shards whose stream is not the reference greedy
  encoder's, and ``bytes_wrong``, the bytes of the reference decoder's
  output of the program's stream that differ from the input shard (with
  the length difference).

Decode cells (:func:`check_decode`): ``bytes_wrong`` over every kept output
against its input; ``frame_faults`` of the pool's containers; and
``container_bytes_wrong``, the reference decoder's output of a sample of
the containers' shards against the input.

The reference runs after the window, its shards spread over processes.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import random
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import tamp_plain as T

__all__ = ["check_encode", "check_decode", "control_decode", "diff"]


def diff(got, want) -> int:
    """The bytes at which ``got`` and ``want`` differ, plus their length
    difference."""
    n = min(len(got), len(want))
    a = np.frombuffer(memoryview(got)[:n], np.uint8)
    b = np.frombuffer(memoryview(want)[:n], np.uint8)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def _map(fn, jobs: list) -> list:
    """``fn`` over ``jobs`` in spawned processes, one a CPU at most."""
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    n = min(len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(fn, jobs))


def _decode_wrong(stream: bytes, want: bytes, rle_window: int) -> int:
    try:
        return diff(T.decode(stream, rle_window=rle_window), want)
    except ValueError:
        return len(want)


def _encode_job(job) -> tuple[int, int]:
    shard, stream, window, literal, extended = job
    ref = T.encode(shard, window=window, literal=literal, extended=extended)
    return int(ref != stream), _decode_wrong(stream, shard, T.RLE_WINDOW_MAX)


def _decode_job(job) -> int:
    stream, want = job
    return _decode_wrong(stream, want, T.RLE_WINDOW_MAX)


def _frame(blob, raw: bytes, shard_bytes: int):
    """(faults, streams or None) of one container of ``raw``."""
    try:
        ver, raw_size, shard_size, streams = T.parse_frame(blob)
    except T.FrameError:
        return 1, None
    want = max(1, -(-len(raw) // shard_bytes))
    faults = ((ver != 2) + (raw_size != len(raw))
              + (shard_size != shard_bytes) + (len(streams) != want))
    return faults, streams if len(streams) == want else None


def _shards(items, shard_bytes: int):
    """(frame faults, [(input shard, stream)]) of ``(input, container)``
    pairs."""
    faults, pairs = 0, []
    for raw, blob in items:
        f, streams = _frame(blob, raw, shard_bytes)
        faults += f
        if streams is not None:
            pairs += [(raw[j * shard_bytes : (j + 1) * shard_bytes], s)
                      for j, s in enumerate(streams)]
    return faults, pairs


def check_encode(items, *, window: int, literal: int, extended: bool,
                 shard_bytes: int, sample: int, seed: int) -> dict:
    """``{name: (value, limit)}`` of ``(input, container)`` pairs."""
    faults, pairs = _shards(items, shard_bytes)
    pick = random.Random(seed).sample(pairs, min(sample, len(pairs)))
    res = _map(_encode_job, [(raw, s, window, literal, extended)
                             for raw, s in pick])
    return {"frame_faults": (faults, 0),
            "streams_unequal": (sum(r[0] for r in res), 0),
            "bytes_wrong": (sum(r[1] for r in res), 0)}


def check_decode(outputs, containers, *, shard_bytes: int, sample: int,
                 seed: int) -> dict:
    """``{name: (value, limit)}`` of ``(input, output)`` pairs and of the
    ``(input, container)`` pairs the outputs were decoded from."""
    wrong = sum(diff(out, raw) for raw, out in outputs)
    faults, pairs = _shards(containers, shard_bytes)
    pick = random.Random(seed).sample(pairs, min(sample, len(pairs)))
    res = _map(_decode_job, [(s, raw) for raw, s in pick])
    return {"bytes_wrong": (wrong, 0), "frame_faults": (faults, 0),
            "container_bytes_wrong": (sum(res), 0)}


def _control_job(stream: bytes) -> bytes:
    try:
        return T.decode(stream, rle_window=255)
    except ValueError:
        return b""


def control_decode(blob) -> bytes:
    """The decode control: the reference decoder in the program's place,
    every shard decoded, but with each run written whole into the window
    (the format writes at most 8 of its bytes)."""
    _ver, _raw, _ss, streams = T.parse_frame(blob)
    return b"".join(_map(_control_job, streams))

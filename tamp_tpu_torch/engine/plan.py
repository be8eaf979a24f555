"""Host run planning for the planned extended-format encode.

Copy of the JAX package's ``engine/plan.py`` plus its chunk-count stream
(``engine/pipeline_ext._chunk_counts``).  Long byte runs (>= 9) are
RLE-encoded at fixed positions, so the window-write truncations of RLE
become part of the model history ``C-hat`` and the match tables stay
exact.  Per maximal run ``[s, e)``:

- tokens may not cross ``s + 1`` (the byte at ``s`` is emitted by ordinary
  tokenization and becomes the ring's last byte);
- ``[s+1, e)`` is covered by RLE chunks (<= 241, never leaving a trailing
  single byte); each chunk writes ``min(8, chunk, W - pos)`` bytes into
  the window (ring-end aware: RLE writes never wrap), the rest are dropped
  from the model history.
"""

from __future__ import annotations

import numpy as np

MIN_PLANNED_RUN = 9
RLE_MAX = 241
RLE_MAX_WIN = 8

__all__ = ["plan_runs", "build_model_history", "chunk_counts", "ext_prep",
           "MIN_PLANNED_RUN", "RLE_MAX", "RLE_MAX_WIN"]


def plan_runs(data: np.ndarray) -> np.ndarray:
    """(n_plans, 2) int64 array of (rle_start, end) pairs for runs >= 9."""
    n = data.shape[0]
    if n < MIN_PLANNED_RUN:
        return np.zeros((0, 2), dtype=np.int64)
    change = np.nonzero(np.diff(data))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    sel = (ends - starts) >= MIN_PLANNED_RUN
    s, e = starts[sel], ends[sel]
    return np.stack([s + 1, e], axis=1).astype(np.int64)


def _chunk_keep_mask(length: int, pos: int, W: int) -> np.ndarray:
    """Keep-mask of one RLE region under the chunk rule; ``pos`` is the ring
    position at the region's model start (chunk writes stop at the ring
    end)."""
    keep = np.zeros(length, dtype=bool)
    t = 0
    while t < length:
        c = min(RLE_MAX, length - t)
        if length - t - c == 1:
            c -= 1
        k = min(RLE_MAX_WIN, c, W - pos)
        pos = (pos + k) % W
        keep[t : t + k] = True
        t += c
    return keep


def build_model_history(data: np.ndarray, plans: np.ndarray,
                        window_bits: int):
    """(keep_mask, khat, dh) of the exact planned model history.

    ``khat[t]`` = number of model-written bytes among input positions < t
    (one extra trailing entry ``khat[N]``); ``dh`` = the written byte stream
    the window model sees (``C-hat`` minus the dictionary)."""
    n = data.shape[0]
    keep = np.ones(n, dtype=bool)
    W = 1 << window_bits
    kept_before = 0  # kept count over [0, prev region end)
    prev_end = 0
    for s, e in plans:
        kept_before += int(s - prev_end)  # inter-region bytes: all kept
        m = _chunk_keep_mask(int(e - s), kept_before % W, W)
        keep[s:e] = m
        kept_before += int(m.sum())
        prev_end = int(e)
    khat = np.zeros(n + 1, dtype=np.uint32)
    khat[1:] = np.cumsum(keep, dtype=np.uint32)
    return keep, khat, data[keep]


def chunk_counts(plans, khat, M: int) -> np.ndarray:
    """``rc[mp]`` = the forced-RLE chunk's input run count (2..241) at the
    chunk's model start, 0 elsewhere (uint8, M entries): the only region
    plane the device needs (ops/plan_ext.derive_region_arrays)."""
    rc = np.zeros(M, np.uint8)
    for s, e in plans:
        t = int(s)
        e = int(e)
        while t < e:
            remn = e - t
            c = remn if remn < RLE_MAX else RLE_MAX
            if remn - c == 1:
                c -= 1
            rc[int(khat[t])] = c
            t += c
    return rc


def ext_prep(data: np.ndarray, window: int):
    """(plans, khat, dh, rc) of one shard: the host half of the planned
    extended encode."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    plans = plan_runs(data)
    _keep, khat, dh = build_model_history(data, plans, window)
    return plans, khat, dh, chunk_counts(plans, khat, dh.shape[0])

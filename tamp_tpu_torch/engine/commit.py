"""Host ring search of the v1 encode's last < 16 bytes.

Copy of ``ring_model_snapshot`` and ``ring_find_longest`` from the JAX
package's ``engine/commit.py`` (pure NumPy): the v1 host tail
(engine/pipeline.py) replays the reference's shrinking look-ahead search
over a materialized ring, because the 16-byte table cap cannot reproduce
its tie-breaks there.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ring_model_snapshot", "ring_find_longest"]


def ring_model_snapshot(C: np.ndarray, t: int, window_bits: int) -> bytearray:
    """Materialize the v1-model ring buffer at input position ``t``.

    ``C = dictionary || data``; slot ``x`` holds the most recent write, i.e.
    ``C[W + t - tau + x]`` for ``x < tau`` and ``C[t - tau + x]`` otherwise.
    """
    W = 1 << window_bits
    tau = t % W
    ring = bytearray(W)
    ring[:tau] = C[W + t - tau : W + t].tobytes()
    ring[tau:] = C[t : t + W - tau].tobytes()
    return ring


def ring_find_longest(ring, target, min_pattern: int, cap: int):
    """Reference growing-prefix search over a linear ring buffer: the
    lowest slot of the longest match of ``target`` (at most ``cap``
    bytes); ``(0, 0)`` when the target is shorter than ``min_pattern``."""
    limit = min(len(target), cap)
    if limit < min_pattern:
        return 0, 0
    buf = bytes(ring)
    size = min_pattern
    idx = buf.find(bytes(target[:size]))
    if idx < 0:
        return 0, size - 1
    while size < limit:
        nxt = buf.find(bytes(target[: size + 1]), idx)
        if nxt < 0:
            break
        idx = nxt
        size += 1
    return idx, size

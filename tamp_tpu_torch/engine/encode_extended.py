"""Extended-format encode of ``engine="device"``: kernel B5 on the planned
model history, then the host table committer.

Counterpart of the JAX package's ``engine/encode_extended.encode_extended``
as its ``engine/pipeline.encode_device`` runs it (the Pallas search):

  1. host, one thread a shard: the run plan and the exact ring-aware
     model history (engine/greedy.host_ext_prep, the C++ ``tpt_ext_prep``:
     ``plans``, ``khat``, the model stream ``dh``);
  2. card, one launch per batch: kernel B5's cap-16 tables (and, under lazy
     matching, the probe family) of ``dh`` against the extended dictionary,
     pulled in one copy (engine/pipeline.card_tables);
  3. host, one thread a shard: the table rows gathered back to input
     positions (``min(khat[:-1], M - 1)``), then the table committer
     (engine/greedy.table_compress) in table mode with the plan and
     ``khat``, twice, with and without divergence avoidance, keeping the
     shorter stream (a tie goes to avoidance).

Streams are byte-identical to the JAX package's ``encode_extended`` at
windows 8-15; every stream is a valid extended Tamp stream.
"""

from __future__ import annotations

import numpy as np

from ..constants import compute_min_pattern_size
from ..device import resolve_device
from .greedy import host_ext_prep, table_compress, window_array
from .pipeline import card_tables, per_shard, unpack_tables

__all__ = ["encode_extended", "encode_extended_batch", "model_inputs",
           "commit_extended", "ext_commits"]


def model_inputs(data: np.ndarray, window: int):
    """(plans, khat, dh) of one shard: the run plan, the model write counts
    and the model stream (engine/greedy.host_ext_prep)."""
    return host_ext_prep(data, window)[:3]


def commit_extended(data: np.ndarray, plans, khat, tables, *, window: int,
                    literal: int, lazy_matching: bool, dictionary,
                    avoid_divergence: bool | None = None) -> bytes:
    """One shard's stream from its model-history tables gathered to input
    positions: the table committer with and without divergence avoidance
    (``avoid_divergence=None``) keeping the shorter, a tie to avoidance,
    or the one way asked for."""
    def commit(avoid: bool) -> bytes:
        return table_compress(
            data, window=window, literal=literal,
            lazy_matching=lazy_matching, dictionary=dictionary,
            tables=tables, khat=khat, plan=plans, avoid_divergence=avoid)

    if avoid_divergence is not None:
        return commit(avoid_divergence)
    return min(commit(True), commit(False), key=len)


def encode_extended_batch(datas, *, window: int = 10, literal: int = 8,
                          lazy_matching: bool = False, dictionary=None,
                          device=None, workers: int | None = None
                          ) -> list[bytes]:
    """Extended streams of a batch of shards (uint8 arrays): the model
    inputs on one thread a shard, kernel B5 once for the batch, the
    commits on one thread a shard (``workers`` at a time)."""
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    dict_arr = window_array(window, literal, dictionary)
    if not datas:
        return []
    model = per_shard(lambda i: model_inputs(datas[i], window), len(datas),
                      workers)
    planes = card_tables([m[2] for m in model], dict_arr, dev,
                         window=window, lazy=lazy_matching)
    return ext_commits(datas, model, planes, window=window, literal=literal,
                       lazy_matching=lazy_matching, dictionary=dictionary,
                       workers=workers)


def ext_commits(datas, model, planes: np.ndarray, *, window: int,
                literal: int, lazy_matching: bool, dictionary,
                workers=None) -> list[bytes]:
    """Each shard's stream from its model inputs and its rows of the
    pulled ``planes`` (by model position): the gather to input positions
    and :func:`commit_extended`, one thread a shard."""
    def one(i: int) -> bytes:
        plans, khat, dh = model[i]
        rows = np.minimum(khat[:-1], max(0, dh.shape[0] - 1))
        return commit_extended(
            datas[i], plans, khat, unpack_tables(planes[:, i, rows]),
            window=window, literal=literal, lazy_matching=lazy_matching,
            dictionary=dictionary)

    return per_shard(one, len(datas), workers)


def encode_extended(data, *, window: int = 10, literal: int = 8,
                    lazy_matching: bool = False, dictionary=None,
                    device=None) -> bytes:
    """One extended-format Tamp stream of ``data`` (the JAX package's
    ``encode_extended`` with the card's tables, both commits kept to the
    shorter): a batch of one.  ``device``: None for the CUDA card;
    ``"cpu"`` runs B5's plain version."""
    return encode_extended_batch(
        [np.frombuffer(bytes(data), np.uint8)], window=window,
        literal=literal, lazy_matching=lazy_matching, dictionary=dictionary,
        device=device)[0]

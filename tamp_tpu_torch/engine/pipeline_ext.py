"""Extended-format encode with the planned model, on the card.

Counterpart of ``tamp_tpu/engine/pipeline_ext.encode_ext_device_commit``
(its device-tables branch and the fused stage ``_ext_device_stage_impl``):

  1. host: run plan, exact ring-aware model history and chunk counts per
     shard (engine/plan.py);
  2. device, one stage per batch (:func:`ext_device_stage`): the planned
     fields (:func:`ext_fields`: region planes from the chunk counts, the
     sentinel-filled model bytes, kernel B1 (both match-table families)
     or, under lazy matching, kernel B2 (the same and the probe family),
     the field planner of ops/plan_ext.py with its lazy deferral), then
     kernel B3 (the planned-fields commit);
  3. host: the last < 16 model bytes of each shard (engine/tail.py), from
     the kernel's stop and bit remainder and a few table rows.  The
     planned walk never defers there (its lazy deferral needs 16 bytes
     ahead), so the tail is the same with lazy matching on or off.

Output is byte-identical to the JAX package's device-commit encode and to
the native planned committer (``force_planned=True,
avoid_divergence=True``).  Only the dense (S, NP) uint8 chunk-count plane
crosses to the device with the model bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import compute_min_pattern_size
from ..device import resolve_device
from ..dictionary import dictionary_array
from ..exceptions import ExcessBitsError
from ..ops.encode_commit import (
    ERR_EXCESS, S_ACC, S_AN, S_ERR, S_T, TILE, commit_fields,
)
from ..ops.match_ext import ext_tables, ext_tables_probe
from ..ops.plan_ext import (
    MAX_PLAN_WINDOW, SPLIT_WINDOW, derive_region_arrays, plan_fields_ext,
)
from .encode import build_header
from .pipeline import pull_body_bytes
from .plan import ext_prep
from .tail import TAIL_ROWS, ext_tail_bits

__all__ = ["encode_ext_device_commit", "ext_device_stage", "ext_fields",
           "prepare_batch"]


def ext_fields(dh_u8: torch.Tensor, rc_u8: torch.Tensor, npos: torch.Tensor,
               dict_u8: torch.Tensor, *, window: int, literal: int,
               lazy: bool = False):
    """Planned fields of one batch: (tables, A, B).

    ``dh_u8``/``rc_u8``: (S, NP) uint8 model bytes and chunk counts;
    ``npos``: (S,) int32 model lengths; ``dict_u8``: (W,) uint8.  Runs the
    region planes, the sentinel fill, kernel B1 (the four match tables
    len16, idx16, lenx, idxx) or with ``lazy`` kernel B2 (the same four and
    the probe planes plen, pidx), and the field planner; A and B are the
    commit's (S, NP) int32 field planes, ``tables`` the four tables."""
    NP = dh_u8.shape[1]
    maxpat = compute_min_pattern_size(window, literal) + 131
    rc = rc_u8.to(torch.int32)
    bound, rk = derive_region_arrays(rc, window=window)
    col = torch.arange(NP, dtype=torch.int32, device=dh_u8.device)
    dh_sent = torch.where(col[None, :] < npos[:, None],
                          dh_u8.to(torch.int32), 0x1FF)
    plen = pidx = None
    if lazy:
        *tabs, plen, pidx = ext_tables_probe(dh_u8, npos, dict_u8,
                                             window_bits=window, LEXT=maxpat)
    else:
        tabs = ext_tables(dh_u8, npos, dict_u8, window_bits=window,
                          LEXT=maxpat)
    A, B = plan_fields_ext(dh_sent, *tabs, bound, rc, rk, window=window,
                           literal=literal, dlast=int(dict_u8[-1]),
                           plen=plen, pidx=pidx)
    return tuple(tabs), A, B


def ext_device_stage(dh_u8: torch.Tensor, rc_u8: torch.Tensor,
                     npos: torch.Tensor, dict_u8: torch.Tensor, *,
                     window: int, literal: int, lazy: bool = False):
    """Device half of the encode for one batch: (bytes, state, tables).

    Inputs as :func:`ext_fields`.  Returns the commit's (kernel B3) byte
    rows and state rows and the four match tables the host tail reads a
    few rows of."""
    tabs, A, B = ext_fields(dh_u8, rc_u8, npos, dict_u8, window=window,
                            literal=literal, lazy=lazy)
    NP = dh_u8.shape[1]
    out, state = commit_fields(
        A, B, npos, max_out=NP + NP // 8 + 64,
        idx_bits=window if window >= SPLIT_WINDOW else 0)
    return out, state, tabs


def prepare_batch(datas, *, window: int):
    """Host prep of a batch: per-shard (plans, khat, dh, rc) and the padded
    (S, NP) uint8 model-byte and chunk-count planes plus (S,) npos."""
    prep = [ext_prep(d, window) for d in datas]
    S = len(prep)
    maxM = max(p[2].shape[0] for p in prep)
    NP = 1 << (max(maxM, TILE, 1) - 1).bit_length()
    npos = np.asarray([p[2].shape[0] for p in prep], np.int32)
    dh = np.zeros((S, NP), np.uint8)
    rc = np.zeros((S, NP), np.uint8)
    for i, (_plans, _khat, d, r) in enumerate(prep):
        dh[i, : d.shape[0]] = d
        rc[i, : r.shape[0]] = r
    return prep, dh, rc, npos


def _window_dict(window: int, literal: int, dictionary) -> np.ndarray:
    W = 1 << window
    if dictionary is None:
        return dictionary_array(W, literal=literal)
    arr = np.frombuffer(bytes(dictionary), np.uint8)
    if arr.shape[0] != W:
        raise ValueError("Dictionary-window size mismatch.")
    return arr


def encode_ext_device_commit(shards, *, window: int = 10, literal: int = 8,
                             lazy_matching: bool = False,
                             dictionary: bytes | None = None,
                             device=None) -> list[bytes]:
    """Extended-format encode of a batch of shards; one Tamp stream each.

    ``lazy_matching``: the planned walk's pure-position deferral (kernel B2
    and the planner's lazy rule).  ``dictionary``: a full-window custom
    dictionary (bytes or uint8 array), else the extended format's default
    (``dictionary_array(W, literal)``).
    ``device``: None for the CUDA card; ``"cpu"`` runs the plain versions.
    """
    if window > MAX_PLAN_WINDOW:
        raise ValueError(
            f"device extended encode supports window <= {MAX_PLAN_WINDOW}")
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    dict_arr = _window_dict(window, literal, dictionary)
    datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
    S = len(datas)
    if S == 0:
        return []
    prep, dh, rc, npos = prepare_batch(datas, window=window)

    npos_d = torch.from_numpy(npos).to(dev)
    out, state, tabs = ext_device_stage(
        torch.from_numpy(dh).to(dev), torch.from_numpy(rc).to(dev), npos_d,
        torch.from_numpy(dict_arr.copy()).to(dev), window=window,
        literal=literal, lazy=lazy_matching)
    state = state.cpu().numpy()
    if (state[:, S_ERR] == ERR_EXCESS).any():
        raise ExcessBitsError
    if (state[:, S_ERR] != 0).any():
        raise RuntimeError("commit walk stalled on malformed fields")
    bodies = pull_body_bytes(out, state)
    # the tail walk reads table rows at model positions >= npos - 15 only
    base = torch.clamp_min(npos_d - TAIL_ROWS, 0)
    ridx = torch.clamp_max(
        base[:, None] + torch.arange(TAIL_ROWS, device=dev)[None, :],
        dh.shape[1] - 1).long()
    rows = torch.stack([torch.gather(t, 1, ridx) for t in tabs]).cpu().numpy()
    base = base.cpu().numpy()

    (hv, hn), = build_header(window, literal, dictionary is not None, True,
                             False)
    results: list[bytes] = []
    for i, data in enumerate(datas):
        st = state[i]
        plans, khat, dhi, _rc = prep[i]
        t_m = int(st[S_T])
        # model position t_m -> the input position holding it (khat is
        # nondecreasing; the kept position where it first reaches t_m + 1)
        if t_m < dhi.shape[0]:
            t_in = int(np.searchsorted(khat, t_m + 1, side="left")) - 1
        else:
            t_in = data.shape[0]
        tail = ext_tail_bits(
            data, t_in, dhi, khat, plans, tuple(rows[:, i]), int(base[i]),
            window=window, literal=literal, acc=int(st[S_ACC]),
            an=int(st[S_AN]), dict_last=int(dict_arr[-1]))
        results.append(bytes([hv]) + bodies[i].tobytes() + tail)
    return results

"""Extended-format encodes on the card: the planned model and greedy parity.

:func:`encode_ext_device_commit` is the counterpart of
``tamp_tpu/engine/pipeline_ext.encode_ext_device_commit`` (its
device-tables branch and the fused stage ``_ext_device_stage_impl``):

  1. host, one thread a shard: run plan, exact ring-aware model history
     and chunk counts in one pass (engine/greedy.host_ext_prep, the C++
     ``tpt_ext_prep`` of csrc/greedy_commit.cpp);
  2. device, one stage per batch (:func:`ext_device_stage`): the planned
     fields (:func:`ext_fields`: region planes from the chunk counts, the
     sentinel-filled model bytes, kernel B1 (both match-table families)
     or, under lazy matching, kernel B2 (the same and the probe family),
     the field planner of ops/plan_ext.py with its lazy deferral), then
     kernel B3 (the planned-fields commit);
  3. host, one shard after another: the last < 16 model bytes of each
     shard from the kernel's stop and bit remainder
     (engine/greedy.host_ext_tail_bits, the C++ ``tpt_ext_tail_bits``),
     which replays the model stream's last window into its ring and
     searches there, so no table row leaves the card.  The planned walk
     never defers there (its lazy deferral needs 16 bytes ahead), so the
     tail is the same with lazy matching on or off.

engine/plan.py and engine/tail.py are the plain versions of steps 1 and 3
that the tests hold the C++ to; the main path reaches neither.

Output is byte-identical to the native planned committer
(``force_planned=True, avoid_divergence=True``) and to the JAX package's
device-commit encode, but for a shard that opens with a planned run of the
dictionary's last byte: there the JAX planner lets an RLE token cross the
first forced chunk and writes a stream that does not decode, and this one
stops the run at the chunk as the committer does (ops/plan_ext.py).  Only
the dense (S, NP) uint8 chunk-count plane crosses to the device with the
model bytes.  While tracing is on, the steps are the spans
``tamp.encode.prep`` (``tamp.encode.prep.shard`` a shard), ``.h2d``,
``.device`` (``.plan`` twice inside it), ``.pull`` and ``.tail``.

:func:`encode_ext_device_greedy` is the counterpart of the JAX package's
``encode_ext_device_greedy`` (its device-tables branch): kernel B5's cap-16
(and probe) tables of the raw shards on the card, then the host greedy
committer (engine/greedy.py) per shard, whose streams are byte-identical
to the reference greedy encoder.  The card ships the tables sparsely, at
the token starts kernel B7 predicts (ops/greedy_predict.py), or densely.

:func:`encode_ext_device_optimal` is the counterpart of the JAX package's
``encode_ext_device_optimal``: per shard on the host the forced-RLE
regions (engine/encode.opt_ext_runs), the khat-aware cap-maxpat tables
(engine/greedy.host_v1_tables) and the packed DP plane with its chunk
sideband (:func:`optimal_prep`); on the card kernel X4's DP; on the host
the choice walk (engine/greedy.opt_ext_walk) and the bit pack
(engine/encode.opt_ext_emit).  Streams are byte-identical to the JAX
package's ``encode_extended_optimal``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..constants import HUFFMAN_LENGTHS, compute_min_pattern_size
from ..device import resolve_device
from ..exceptions import ExcessBitsError
from ..ops.encode_commit import (
    ERR_EXCESS, S_ACC, S_AN, S_ERR, S_T, TILE, commit_fields,
)
from ..ops.greedy_predict import greedy_predict_batch, pack_predict_plane
from ..ops.match_ext import ext_tables, ext_tables_probe
from ..ops.match_v1 import v1_tables
from ..ops.opt_parse_ext import opt_ext_choice
from ..ops.plan_ext import (
    MAX_PLAN_WINDOW, SPLIT_WINDOW, derive_region_arrays, plan_fields_ext,
)
from .encode import build_header, opt_ext_emit, opt_ext_runs
from .greedy import (
    COMMIT_STATS, SPARSE_NONE, greedy_compress, host_ext_prep,
    host_ext_tail_bits, host_v1_tables, opt_ext_walk, window_array,
)
from .pipeline import (
    pack_tables, pad_shards, per_shard, pull_body_bytes, unpack_tables,
)

__all__ = ["encode_ext_device_commit", "encode_ext_device_greedy",
           "ext_device_stage", "ext_fields", "prepare_batch", "ext_tails",
           "resume_position",
           "greedy_tables", "greedy_predict_planes", "greedy_sparse_stage",
           "greedy_dense_stage", "pull_sparse", "sparse_tables",
           "greedy_commits", "encode_ext_device_optimal", "optimal_prep",
           "optimal_prep_shard", "optimal_batch", "optimal_emit"]


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
    dev = dh_u8.device
    with trace.span("tamp.encode.plan", device=dev):
        rc = rc_u8.to(torch.int32)
        bound, rk = derive_region_arrays(rc, window=window)
        col = torch.arange(NP, dtype=torch.int32, device=dev)
        dh_sent = torch.where(col[None, :] < npos[:, None],
                              dh_u8.to(torch.int32), 0x1FF)
    plen = pidx = None
    if lazy:
        *tabs, plen, pidx = ext_tables_probe(dh_u8, npos, dict_u8,
                                             window_bits=window, LEXT=maxpat)
    else:
        tabs = ext_tables(dh_u8, npos, dict_u8, window_bits=window,
                          LEXT=maxpat)
    with trace.span("tamp.encode.plan", device=dev):
        A, B = plan_fields_ext(dh_sent, *tabs, bound, rc, rk, window=window,
                               literal=literal, dlast=int(dict_u8[-1]),
                               plen=plen, pidx=pidx)
    return tuple(tabs), A, B


def ext_device_stage(dh_u8: torch.Tensor, rc_u8: torch.Tensor,
                     npos: torch.Tensor, dict_u8: torch.Tensor, *,
                     window: int, literal: int, lazy: bool = False):
    """Device half of the encode for one batch: (bytes, state).

    Inputs as :func:`ext_fields`.  Returns the commit's (kernel B3) byte
    rows and state rows."""
    A, B = ext_fields(dh_u8, rc_u8, npos, dict_u8, window=window,
                      literal=literal, lazy=lazy)[1:]
    NP = dh_u8.shape[1]
    return commit_fields(A, B, npos, max_out=NP + NP // 8 + 64,
                         idx_bits=window if window >= SPLIT_WINDOW else 0)


def prepare_batch(datas, *, window: int):
    """Host prep of a batch: per-shard (plans, khat, dh, rc) from
    engine/greedy.host_ext_prep, one thread a shard, and the padded (S, NP)
    uint8 model-byte and chunk-count planes plus (S,) npos.  While tracing
    is on, each shard is a span of its own and the bytes of its forced RLE
    regions are counted."""
    def shard(i: int):
        with trace.span("tamp.encode.prep.shard", bytes=datas[i].nbytes):
            out = host_ext_prep(datas[i], window)
            if trace.enabled():
                plans = out[0]
                trace.count("encode.planned_bytes",
                            int((plans[:, 1] - plans[:, 0]).sum()))
            return out

    prep = per_shard(shard, len(datas))
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
    dict_arr = window_array(window, literal, dictionary)
    with trace.span("tamp.encode.prep"):
        datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
        S = len(datas)
        if S == 0:
            return []
        prep, dh, rc, npos = prepare_batch(datas, window=window)
        trace.count("encode.model_bytes", int(npos.sum()))

    with trace.span("tamp.encode.h2d"):
        dh_d = torch.from_numpy(dh).to(dev)
        rc_d = torch.from_numpy(rc).to(dev)
        npos_d = torch.from_numpy(npos).to(dev)
        dict_d = torch.from_numpy(dict_arr.copy()).to(dev)
        trace.count("encode.h2d_bytes", dh.nbytes + rc.nbytes + npos.nbytes
                    + dict_arr.nbytes)
    with trace.span("tamp.encode.device", device=dev):
        out, state = ext_device_stage(dh_d, rc_d, npos_d, dict_d,
                                      window=window, literal=literal,
                                      lazy=lazy_matching)
        # the inputs' device memory goes back before the pull
        del dh_d, rc_d, npos_d, dict_d
    with trace.span("tamp.encode.pull"):
        state = state.cpu().numpy()
        trace.count("encode.pull_bytes", state.nbytes)
        if (state[:, S_ERR] == ERR_EXCESS).any():
            raise ExcessBitsError
        if (state[:, S_ERR] != 0).any():
            raise RuntimeError("commit walk stalled on malformed fields")
        bodies = pull_body_bytes(out, state)
    with trace.span("tamp.encode.tail"):
        tails = ext_tails(datas, prep, state, window=window, literal=literal,
                          lazy=lazy_matching, dict_arr=dict_arr)
        (hv, _hn), = build_header(window, literal, dictionary is not None,
                                  True, False)
        blobs = [bytes([hv]) + body.tobytes() + tail
                 for body, tail in zip(bodies, tails)]
        # the prep's host arrays (~6 bytes a byte of input) go back inside
        # the span, not in the return's release of the locals
        del prep
        return blobs


def ext_tails(datas, prep, state: np.ndarray, *, window: int, literal: int,
              lazy: bool, dict_arr: np.ndarray) -> list[bytes]:
    """Each shard's tail bytes after the commit kernel (``state`` on the
    host): engine/greedy.host_ext_tail_bits from the kernel's stop and bit
    remainder, one shard after another on the calling thread, as the JAX
    package runs them: a tail walks < 16 bytes (~0.05 ms), less than a
    thread pool's start (~1.7 ms for 8 shards on an H100 host)."""
    tails = []
    for data, (plans, khat, dhi, _rc), st in zip(datas, prep, state):
        tails.append(host_ext_tail_bits(
            data, resume_position(khat, int(st[S_T]), dhi.shape[0]), dhi,
            khat, plans, window=window, literal=literal, acc=int(st[S_ACC]),
            an=int(st[S_AN]), lazy=lazy, dictionary=dict_arr))
    return tails


def resume_position(khat: np.ndarray, t_m: int, M: int) -> int:
    """The input position of model position ``t_m`` (the commit kernel's
    stop) of a shard with ``M`` model bytes: where the nondecreasing
    ``khat`` first reaches ``t_m + 1``, less one; the input's end past
    the model's."""
    if t_m >= M:
        return khat.shape[0] - 1
    # a key of khat's own type: with a Python int NumPy casts the whole
    # array first (~0.7 ms a MiB)
    return int(np.searchsorted(khat, khat.dtype.type(t_m + 1))) - 1


def greedy_tables(dh_u8: torch.Tensor, npos: torch.Tensor,
                  dict_u8: torch.Tensor, *, window: int, lazy: bool):
    """Kernel B5's cap-16 tables of the raw shards ``dh_u8`` (S, NP) uint8
    against the extended dictionary: (len16, idx16) and with ``lazy`` the
    probe family (plen, pidx) as well."""
    return v1_tables(dh_u8, npos, dict_u8, window_bits=window, cap=16,
                     probe=lazy)


def greedy_predict_planes(dh_u8: torch.Tensor, npos: torch.Tensor, tabs,
                          dlast: int, *, lazy: bool):
    """Kernel B7's inputs from :func:`greedy_tables`' output: the packed
    walker plane and the probe plane (None without ``lazy``)."""
    pk = pack_predict_plane(dh_u8, npos, tabs[0], tabs[1], dlast=dlast)
    pp = ((tabs[3] & 0x7FFF) | ((tabs[2] & 15) << 15)) if lazy else None
    return pk, pp


def greedy_sparse_stage(dh_u8: torch.Tensor, npos: torch.Tensor,
                        dict_u8: torch.Tensor, *, window: int, literal: int,
                        lazy: bool):
    """Device half of the sparse pull for one batch: the tables, the packed
    planes and kernel B7.  Returns B7's (bitmap, entries, state)."""
    tabs = greedy_tables(dh_u8, npos, dict_u8, window=window, lazy=lazy)
    pk, pp = greedy_predict_planes(dh_u8, npos, tabs, int(dict_u8[-1]),
                                   lazy=lazy)
    return greedy_predict_batch(pk, pp, npos, NP=dh_u8.shape[1],
                                window=window, literal=literal, lazy=lazy)


def pull_sparse(bm: torch.Tensor, ent: torch.Tensor, lazy: bool):
    """Host side of the sparse pull: B7's start bitmap as (S, NP) bits,
    then the first K words of each entry row, K the largest row's entry
    count rounded up to a power of two (at least 512)."""
    bits = np.unpackbits(bm.cpu().numpy().view(np.uint8), axis=1,
                         bitorder="little")
    kmax = int(bits.sum(axis=1).max()) * (2 if lazy else 1)
    K = min(1 << max(9, (max(kmax, 1) - 1).bit_length()), ent.shape[1])
    ent_h = ent[:, :K].cpu().numpy()
    trace.count("encode.pull_bytes", bm.nbytes + ent_h.nbytes)
    return bits, ent_h


def greedy_dense_stage(dh_u8: torch.Tensor, npos: torch.Tensor,
                       dict_u8: torch.Tensor, *, window: int, lazy: bool):
    """Device half of the dense pull for one batch: the tables packed for
    one pull by engine/pipeline.pack_tables (``len | idx << 5`` a family,
    int16 when window <= 10, int32 otherwise)."""
    return pack_tables(greedy_tables(dh_u8, npos, dict_u8, window=window,
                                     lazy=lazy), window)


def sparse_tables(bits: np.ndarray, ent: np.ndarray, n: int, lazy: bool):
    """Holed committer tables of one shard from its start-bitmap bits and
    entry row: entries at the predicted starts, SPARSE_NONE elsewhere."""
    starts = np.flatnonzero(bits[:n])
    k = starts.shape[0]
    main = ent[0 : 2 * k : 2] if lazy else ent[:k]
    flen = np.full(n, SPARSE_NONE, np.uint8)
    fidx = np.zeros(n, np.int32)
    flen[starts] = (main >> 15) & 31
    fidx[starts] = main & 0x7FFF
    if not lazy:
        return flen, fidx
    pq = ent[1 : 2 * k : 2]
    plen = np.full(n, SPARSE_NONE, np.uint8)
    pidx = np.zeros(n, np.int32)
    plen[starts] = (pq >> 15) & 15
    pidx[starts] = pq & 0x7FFF
    return flen, fidx, plen, pidx


def greedy_commits(datas, tables, *, window: int = 10, literal: int = 8,
                   lazy_matching: bool = False, dictionary=None) -> list[bytes]:
    """The host committer on each shard of ``datas`` (uint8 arrays), one
    thread per shard; ``tables(i)`` makes shard i's committer tables in its
    thread (None: the table-less exact search).  While tracing is on, each
    shard's table lookups are counted by outcome (engine/greedy.py's
    ``COMMIT_STATS``)."""
    def commit(i: int) -> bytes:
        with trace.span("tamp.encode.commit.shard", bytes=datas[i].nbytes):
            with trace.span("tamp.encode.tables"):
                tabs = tables(i)
            stats = np.zeros(len(COMMIT_STATS), np.int64) \
                if trace.enabled() else None
            blob = greedy_compress(
                datas[i], window=window, literal=literal,
                lazy_matching=lazy_matching, dictionary=dictionary,
                tables=tabs, stats=stats)
            if stats is not None:
                for name, n in zip(COMMIT_STATS, stats.tolist()):
                    trace.count(name, n)
            return blob

    with trace.span("tamp.encode.commit"):
        return per_shard(commit, len(datas))


def encode_ext_device_greedy(shards, *, window: int = 10, literal: int = 8,
                             lazy_matching: bool = False,
                             dictionary: bytes | None = None,
                             pull: str = "sparse", device=None) -> list[bytes]:
    """Reference-greedy extended encode with the match search on the card.

    Each stream is byte-identical to the reference greedy encoder at equal
    settings (``tamp_tpu.compress(shard, extended=True, ...)``).  The card
    computes kernel B5's cap-16 (and probe) tables against the raw input
    history; the host committer (engine/greedy.py) runs the greedy walk
    over them in exact-table mode, one thread per shard, each call with the
    GIL released.

    ``pull`` picks the device-to-host table transfer:

    - ``"sparse"`` (the default, as in the JAX package): kernel B7 replays
      the greedy walk on the card; the host pulls its start bitmap (1 bit
      per position), then the entries at the predicted starts only, and
      hands the committer tables holed everywhere else.  The stream never
      depends on the prediction, only the pull volume and the committer's
      searches do.  It moves fewer bytes than the dense plane where tokens
      are long, and a few more on literal-heavy text, where the dense pull
      is the faster one on an H100 host (PERF.md §5); the default stays
      the JAX package's until a benchmark of the port chooses it.
    - ``"dense"``: the whole packed table plane (2 bytes per position at
      window <= 10, 4 above, doubled by lazy matching).

    The whole batch is one device call; its commits start when its pull
    lands.  ``dictionary``: a full-window custom dictionary, else the
    extended format's default.  ``device``: None for the CUDA card;
    ``"cpu"`` runs the plain versions of B5 and B7."""
    if pull not in ("sparse", "dense"):
        raise ValueError("pull must be 'sparse' or 'dense'")
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    dict_arr = window_array(window, literal, dictionary)
    with trace.span("tamp.encode.prep"):
        datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
        if not datas:
            return []
        dh, npos = pad_shards(datas)
    with trace.span("tamp.encode.h2d"):
        dh_d = torch.from_numpy(dh).to(dev)
        npos_d = torch.from_numpy(npos).to(dev)
        dict_d = torch.from_numpy(dict_arr.copy()).to(dev)
        trace.count("encode.h2d_bytes",
                    dh.nbytes + npos.nbytes + dict_arr.nbytes)
    lazy = lazy_matching
    if pull == "dense":
        with trace.span("tamp.encode.device", device=dev):
            planes_d = greedy_dense_stage(dh_d, npos_d, dict_d,
                                          window=window, lazy=lazy)
        with trace.span("tamp.encode.pull"):
            planes = planes_d.cpu().numpy()
            del planes_d  # its device memory goes back before the commits
            trace.count("encode.pull_bytes", planes.nbytes)

        def tables(i):
            return unpack_tables(planes[:, i, : datas[i].shape[0]])
    else:
        with trace.span("tamp.encode.device", device=dev):
            bm, ent, _state = greedy_sparse_stage(
                dh_d, npos_d, dict_d, window=window, literal=literal,
                lazy=lazy)
        with trace.span("tamp.encode.pull"):
            bits, ent_h = pull_sparse(bm, ent, lazy)

        def tables(i):
            return sparse_tables(bits[i], ent_h[i], datas[i].shape[0], lazy)
    return greedy_commits(datas, tables, window=window, literal=literal,
                          lazy_matching=lazy, dictionary=dictionary)


def optimal_prep(datas, *, window: int, literal: int, dictionary=None):
    """Host prep of kernel X4's inputs: :func:`optimal_prep_shard` of each
    shard of ``datas`` (uint8 arrays), one thread per shard."""
    return per_shard(lambda i: optimal_prep_shard(
        datas[i], window=window, literal=literal, dictionary=dictionary),
        len(datas))


def optimal_prep_shard(arr: np.ndarray, *, window: int, literal: int,
                       dictionary=None):
    """Host prep of one shard for kernel X4: (packed, fidx, runs, cstarts,
    ccost).

    ``packed``: (n,) int32 ``flen | (room - 1) << 8 | bound << 23 |
    interior << 31``: flen the khat-aware cap-maxpat match length, room the
    ring-end cap ``W - (khat[i] mod W)``, bound the distance to the next
    forced-region start clipped to 255, interior set inside a region;
    ``fidx`` the tables' ring slots; ``runs`` the regions; ``cstarts`` and
    ``ccost`` each RLE chunk's start and token bits."""
    W = 1 << window
    n = arr.shape[0]
    maxpat = compute_min_pattern_size(window, literal) + 131
    runs, khat, chunks = opt_ext_runs(arr, window)
    flen, fidx = host_v1_tables(arr, window=window, literal=literal,
                                cap=maxpat, dictionary=dictionary, khat=khat)
    wpos = khat[:n] if khat is not None else np.arange(n, dtype=np.uint32)
    room = (W - (wpos & (W - 1))).astype(np.uint32)
    bound = np.full(n, 255, np.uint32)
    interior = np.zeros(n, np.uint32)
    if runs:
        starts_a = np.asarray([a for a, _ in runs], np.int64)
        idx = np.searchsorted(starts_a, np.arange(n), side="right")
        has = idx < starts_a.shape[0]
        bound[has] = np.minimum(starts_a[idx[has]] - np.flatnonzero(has),
                                255)
        for a, b in runs:
            interior[a:b] = 1
    cstarts = np.asarray([c[0] for c in chunks], np.int32)
    ccost = np.asarray(
        [HUFFMAN_LENGTHS[12] + HUFFMAN_LENGTHS[(c[1] - 2) >> 4] - 1 + 4
         for c in chunks], np.int32)
    packed = (flen.astype(np.uint32) | ((room - 1) << 8) | (bound << 23)
              | (interior << 31)).view(np.int32)
    return packed, fidx, runs, cstarts, ccost


def optimal_batch(datas, prep, *, literal: int):
    """The padded planes of kernel X4: (packed (S, MP) int32, data (S, MP)
    uint8 or None at literal 8, npos (S,), sideband_pos and sideband_cw (S,
    C) int32), MP a power of two >= 1024, C one >= 128; padding sideband
    entries sit at distinct positions >= MP."""
    S = len(datas)
    maxN = max(d.shape[0] for d in datas)
    MP = 1 << max(10, (max(maxN, 1) - 1).bit_length())
    npos = np.asarray([d.shape[0] for d in datas], np.int32)
    pk = np.zeros((S, MP), np.int32)
    for i, p in enumerate(prep):
        pk[i, : p[0].shape[0]] = p[0]
    db = None
    if literal < 8:
        db = np.zeros((S, MP), np.uint8)
        for i, d in enumerate(datas):
            db[i, : d.shape[0]] = d
    kmax = max(p[3].shape[0] for p in prep)
    C = 1 << max(7, (max(kmax, 1) - 1).bit_length())
    sb_pos = MP + np.tile(np.arange(C, dtype=np.int32), (S, 1))
    sb_cw = np.zeros((S, C), np.int32)
    for i, p in enumerate(prep):
        k = p[3].shape[0]
        sb_pos[i, :k] = p[3]
        sb_cw[i, :k] = p[4]
    return pk, db, npos, sb_pos, sb_cw


def optimal_emit(datas, prep, choice: np.ndarray, *, window: int,
                 literal: int, custom_dict: bool) -> list[bytes]:
    """Each shard's stream from the card's choice plane (S, >= n) uint8:
    the choice walk, then the bit pack, one thread per shard."""
    minp = compute_min_pattern_size(window, literal)

    def one(i: int) -> bytes:
        arr = datas[i]
        _pk, fidx, runs, _cs, _cc = prep[i]
        sizes, kinds = opt_ext_walk(choice[i, : arr.shape[0]], minp, runs)
        return opt_ext_emit(arr, sizes, kinds, fidx, window=window,
                            literal=literal, custom_dict=custom_dict)

    return per_shard(one, len(datas))


def encode_ext_device_optimal(shards, *, window: int = 10, literal: int = 8,
                              dictionary: bytes | None = None,
                              device=None) -> list[bytes]:
    """Optimal (minimum-bit) extended encode with the DP on the card.

    Byte-identical to the JAX package's ``encode_extended_optimal``: the
    host finds the forced-RLE regions and builds the khat-aware cap-maxpat
    tables (:func:`optimal_prep`, one thread per shard), the card runs
    kernel X4 over the whole batch in one call (the JAX package splits
    batches of four or more shards in two for the TPU's memory; the
    streams do not depend on it) and sends back the uint8 choice plane,
    and the host expands it into tokens and packs the bits
    (:func:`optimal_emit`).  ``dictionary``: a full-window custom
    dictionary, else the extended format's default.  ``device``: None for
    the CUDA card; ``"cpu"`` runs the plain version.  Raises
    ExcessBitsError where a byte fits neither a literal nor a match."""
    compute_min_pattern_size(window, literal)  # validates the config
    dev = resolve_device(device)
    dict_arr = None
    if dictionary is not None:
        dict_arr = window_array(window, literal, dictionary)
    datas = [np.frombuffer(bytes(b), dtype=np.uint8) for b in shards]
    if not datas:
        return []
    prep = optimal_prep(datas, window=window, literal=literal,
                        dictionary=dict_arr)
    pk, db, npos, sb_pos, sb_cw = optimal_batch(datas, prep, literal=literal)

    def to_dev(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    choice, _cost0, bad = opt_ext_choice(
        to_dev(pk), to_dev(db), to_dev(npos), to_dev(sb_pos), to_dev(sb_cw),
        window=window, literal=literal)
    if bad.any():
        raise ExcessBitsError
    maxN = max(d.shape[0] for d in datas)
    choice = choice[:, : max(maxN, 1)].cpu().numpy()
    return optimal_emit(datas, prep, choice, window=window, literal=literal,
                        custom_dict=dictionary is not None)

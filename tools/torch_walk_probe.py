#!/usr/bin/env python3
"""Time kernels B4, B3, B6, B7, B8 and B5 of the PyTorch/CUDA port beside
the chain floors of their walks and the parts of their work, and X1, X2,
X3 and X4 beside variants with parts cut out, on one NVIDIA card.

    python3 tools/torch_walk_probe.py [--no-variants] [--tables]
                                      [--x [--only x1,x2,x3,x4]]

``--x`` times X2 alone, the serial decode of the main path's payloads
(``x2_ms``, ns a token a shard), X4 alone on the optimal path's planes,
whole and by launch through the profiler (``x4_pass1_ms``,
``x4_combine_ms``, ``x4_pass2_ms``) and again at a block size of 4096
(``x4_b4096_*``), X3 alone on the optimal v1 path's tables, whole and by
launch (``x3_*_ms``, chip_smoke.X3_LAUNCHES), with the share of in-shard
positions that have a match (``x3_match_share``), and X1 alone on the main
path's token table (``x1_ms``, its kernel alone ``x1_kernel_ms``, ns a
truncating token) beside its one-thread chain over the same rows staged
in shared memory (``x1_chain_ms``), each beside its variants
(X2_VARIANTS, X4_VARIANTS, X3_VARIANTS, X1_VARIANTS: sources edited and
built as libraries of their own; a variant whose anchor is not in the
source raises).

Inputs are chip_smoke.py's phase-4 inputs: its seeded text corpus, 8 x 1 MiB
shards, window 10, literal 8.  B4 decodes the main path's container, B3
commits the main path's planned fields, B6 walks the v1 lazy path's packed
tables and B7 (lazy and not) the greedy paths' packed planes; B8 chases
the main path's per-bit parse and B5 makes the v1 tables of the raw
shards (cap 15, without and with the probe family).
``csrc/walk_probe.cu`` walks the same chains in the first port's skeleton
(one thread a shard) and does nothing else; a kernel's time minus its
probe's is what it spends on top of its chain.  B8 is also timed beside a
coalesced read of its whole ``nxt`` plane and the xla mode's tensor-op
token table (``b8_read_ms``, ``b8_xla_ms``, with ``b8_tokens`` and
``b8_nbp``).  B5 is timed beside its first port's skeleton with parts cut
out: the slab staging and the stores alone (``b5_stage_ms``) and the scan
with first-byte compares only (``b5_first_byte_ms``), each also with the
probe family (``b5_probe_*``), and the share of (position, slot) pairs of
the main family whose first byte, and whose first two bytes, match
(``b5_share_1``, ``b5_share_2``).  B1 and B2 are timed on the model
history of the same shards (``engine/pipeline_ext.prepare_batch``, as phase
4 makes it, LEXT = 133) beside the same skeleton's parts run there
(``b1_stage_ms``, ``b1_first_byte_ms``, and with the probe family
``b2_stage_ms``, ``b2_first_byte_ms``), with the shares of (position,
slot) pairs matching one byte, two bytes and 16 bytes or more, runs capped
at min(npos - t, LEXT, W - x) (``b1_share_1``, ``b1_share_2``,
``b1_share_16``), and the mean length past 16 of those reaching 16
(``b1_mean_past_16``); ``--tables`` runs these B1, B2 and B5 parts alone.
B4 is also
timed in variants built from ``csrc/decode_commit.cu`` with parts of its
commit warp cut out (VARIANTS), to split its time between the chain and the
commit; a variant's output is not checked (``--no-variants`` skips them,
for a tree whose kernel source lacks their anchors).  Times are CUDA events, median
of 5 after a warm-up.  Prints one JSON line last, with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_COMMIT = "    __threadfence_block();\n    const int nrec = min(32, head - done);\n"
_PHASES = ("      const int rb = ring", "      out_pos += __shfl_sync")
_PHASE2 = ("      // phase 2:", "      out_pos += __shfl_sync")
# B4 variants: name -> edit of the kernel source
VARIANTS = {
    # the commit warp drains the queue and commits nothing: the chain alone
    "b4_chain_only_ms": lambda src: src.replace(
        _COMMIT, "    done = head;\n    if (lane == 0) *tail_v = done;\n"
        "    continue;\n" + _COMMIT),
    # the chain alone, storing no word in the queue
    "b4_chain_no_queue_ms": lambda src: VARIANTS["b4_chain_only_ms"](
        src).replace("          queue[(n + u) & (Q - 1)] = p;\n", "").replace(
        "      queue[n++ & (Q - 1)] = p;", "      ++n;"),
    # the commit warp copies no byte to the ring (phase 2 cut out)
    "b4_no_ring_writes_ms": lambda src: src[: src.index(_PHASE2[0])]
        + src[src.index(_PHASE2[1]) :],
    # errs counts the commit's batches instead of the error code
    "b4_batches": lambda src: src.replace(
        "    done += kk;\n", "    done += kk;\n      ++nbatch;\n").replace(
        "lwf = 0, err = 0;", "lwf = 0, err = 0, nbatch = 0;").replace(
        "    errs[s] = err;", "    errs[s] = nbatch;"),
    # the commit warp books and cuts batches but copies no byte
    "b4_no_copies_ms": lambda src: src[: src.index(_PHASES[0])]
        + src[src.index(_PHASES[1]) :],
}


def _parse_alone(src: str) -> str:
    """X2's parse lane with the commit warp gone and no wait for room in
    the queue."""
    out, n = re.subn(r"while \(nq \+ 40 - \*tail_v > Q\) \{\s*\}", "", src)
    if n == 0:
        raise RuntimeError("x2_parse_alone: no wait for room in the source")
    return out.replace("  if (threadIdx.x < 32) return;\n",
                       "  if (threadIdx.x < 64) return;\n", 1)


# X2 variants (csrc/decode_serial.cu): name -> edit of the kernel source,
# each cutting the parse lane or the commit warp (their lens are not
# checked: the commit warp writes them).
X2_VARIANTS = {
    # the commit warp drains the queue and commits nothing
    "x2_chain_only_ms": lambda src: src.replace(
        "    const int nrec = min(32, head - done);\n",
        "    if (head > done) {\n      done = head;\n"
        "      if (lane == 0) *tail_v = done;\n      continue;\n    }\n"
        "    const int nrec = min(32, head - done);\n", 1),
    # the parse lane alone: no commit warp, no wait for room
    "x2_parse_alone_ms": lambda src: _parse_alone(src),
    # the parse lane alone reading every token as a literal (a stream of
    # literals' floor)
    "x2_literals_only_ms": lambda src: _parse_alone(src).replace(
        "lds32(tok_a + ((ah >> 23) << 2))",
        "lds32(tok_a + ((256 | ah >> 23) << 2))", 1),
    # the same, storing no record
    "x2_parse_no_queue_ms": lambda src: re.sub(
        r"sts32\(queue_a \+ \(\(nq\+\+ & \(Q - 1\)\) << 2\), ([^;]+)\);",
        r"nq += (\1) != -1;", re.sub(
            r"queue\[nq\+\+ & \(Q - 1\)\] = ([^;]+);",
            r"nq += (\1) != -1;", _parse_alone(src))),
}
_P1_LOOP = """#pragma unroll
        for (int b = 0; b < 12; b++) {
          if (MINP + b > e.y) break;
          m = min(m, r[(MINP + b - 1 - u + WIN) % WIN] + wb[b]);
        }
"""
_P1_SWITCH = ("        switch (min(e.y - MINP, 11)) {\n" + "".join(
    f"          case {b}:\n            m = min(m, r[(MINP + {b - 1} - u + WIN)"
    f" % WIN] + wb[{b}]);\n" + ("            [[fallthrough]];\n" if b else "")
    for b in range(11, -1, -1)) + "          default:\n            break;\n"
    "        }\n")
# X4 variants (csrc/opt_parse.cu): name -> (the launch timed, edit).
X4_VARIANTS = {
    # pass 1's edges by one jump (a switch falling through from the
    # highest advance) in place of an early exit a candidate
    "x4_pass1_switch_ms": ("pass1", lambda src: src.replace(
        _P1_LOOP, _P1_SWITCH, 1)),
    # the cluster combine with 8 CTAs a shard in place of 16
    "x4_combine_cl8_ms": ("combine", lambda src: src.replace(
        "constexpr int CL = 16;", "constexpr int CL = 8;", 1)),
    # pass 2 without its min-plus step (each position's cost its literal
    # edge's): the staging and the edges alone
    "x4_pass2_edges_only_ms": ("pass2", lambda src: src.replace(
        "      const int best = lc <= bm ? lc : bm;",
        "      const int best = lc;", 1)),
    # pass 2 staging only its first chunk (the rest read stale rows)
    "x4_pass2_no_staging_ms": ("pass2", lambda src: src.replace(
        "    if (q + 1 < nq) issue(q + 1);\n    else __pipeline_commit();",
        "    __pipeline_commit();", 1)),
}


# X3 variants (csrc/opt_parse.cu): name -> (the launches timed, as keys
# of chip_smoke.X3_LAUNCHES less spaces, edit)
X3_VARIANTS = {
    # pass 1 relaxing all 14 match advances by selects (no early exit)
    "x3_pass1_selects_ms": (("pass1",), lambda src: src.replace(
        "          if (MINP + b > hi) break;\n"
        "          nv = min(nv, r[(MINP + b - 1 - u + 16) % 16] + wt[b]);",
        "          nv = min(nv, MINP + b <= hi ? "
        "r[(MINP + b - 1 - u + 16) % 16] + wt[b] : INF);", 1)),
    # the combine in groups of 16 blocks in place of 32
    "x3_combine_g16_ms": (("groups", "scan", "bounds"), lambda src:
                          src.replace("constexpr int G = 32;",
                                      "constexpr int G = 16;", 1)),
    # pass 2 staging only its first chunk (the rest read stale rows)
    "x3_pass2_no_staging_ms": (("pass2",), lambda src: src.replace(
        "    issue(q + 1);\n    __pipeline_wait_prior(1);",
        "    __pipeline_commit();\n    __pipeline_wait_prior(1);", 1)),
}
X3_BLOCK_SIZES = (256, 512, 1024, 2048)  # X3 also timed at these
_X1_WALK = """  int out = 0;
  for (int k = 0; k < m; ++k) {
    const int g = __shfl_sync(FULL, sg, k), a = __shfl_sync(FULL, sv, k);
    const int w = __shfl_sync(FULL, wv, k);
    if (g != cur) D = 0;
    const int d = max(0, w - (W - ((a - D) & (W - 1))));
    D += d;
    cur = g;
    if (lane == k) out = d;
  }
  return out;
"""
# X1 variants (csrc/decode_wavefront.cu): name -> edit
X1_VARIANTS = {
    # no tile: the launch and the read of n_tr alone
    "x1_empty_ms": lambda src: src.replace(
        "  const int nt = (n + TR_TILE - 1) / TR_TILE;",
        "  const int nt = 0 * n;", 1),
    # the tiles staged and the deficits stored, no pass run
    "x1_no_fold_ms": lambda src: src.replace(
        "  for (int pos = 0; pos < m;) {", "  for (int pos = m; pos < m;) {",
        1),
    # each chunk walked token by token (the warp in step, reading the
    # tokens by shuffles) in place of the speculative passes
    "x1_walk_ms": lambda src: re.sub(
        r"  int out = 0;\n  for \(int pos = 0; pos < m;\) \{.*?\n"
        r"  return out;\n", lambda _m: _X1_WALK, src, count=1,
        flags=re.S),
}


def variant_lib(name: str, edit, source: str = "decode_commit",
                entry: str = "tpt_commit_decode", n_ptr: int = 6,
                n_int: int = 5):
    """Build the edited copy of ``csrc/<source>.cu`` as its own library
    and return its C entry ``entry`` (``n_ptr`` pointers, ``n_int`` ints,
    the stream); raises if the edit finds no anchor."""
    import ctypes
    import subprocess

    from tamp_tpu_torch.ops import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    text = edit(src)
    if text == src:
        raise RuntimeError(f"variant {name}: its anchor is not in the source")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"probe_{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    return fn


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-variants", action="store_true",
                    help="time B4 and B3 and the chain floors only")
    ap.add_argument("--tables", action="store_true",
                    help="time the match tables B1, B2 and B5 only")
    ap.add_argument("--x", action="store_true",
                    help="time X1, X2, X3 and X4 and their variants only")
    ap.add_argument("--only", default="x1,x2,x3,x4",
                    help="with --x: the kernels to time, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.pipeline_ext import ext_fields, prepare_batch
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.encode_commit import commit_fields
    from tamp_tpu_torch.parallel.shard import (
        DEFAULT_SHARD_SIZE, compress_sharded,
    )

    def ms_of(fn, reps=5):
        return cs.cuda_ms(fn, reps=reps)

    dev = torch.device("cuda")
    window, literal = 10, 8
    W = 1 << window
    data = cs.corpus(8 * DEFAULT_SHARD_SIZE)
    d = torch.from_numpy(dictionary_array(W, literal)).to(dev)
    res = {"card": cs.smi()}
    shards = [np.frombuffer(data[i : i + DEFAULT_SHARD_SIZE], np.uint8)
              for i in range(0, len(data), DEFAULT_SHARD_SIZE)]
    if args.x:
        blob = compress_sharded(data, shard_size=DEFAULT_SHARD_SIZE,
                                device=dev)
        only = args.only.split(",")
        if "x1" in only:
            x1_parts(res, dev, blob, window, literal)
        if "x3" in only:
            x3_parts(res, dev, shards, window, literal)
        if "x2" in only:
            x2_parts(res, dev, blob, d, window, literal)
        if "x4" in only:
            x4_parts(res, dev, shards, window, literal)
        return finish(res)
    _p, dh, rc, npos = prepare_batch(shards, window=window)
    ext_table_parts(res, dev, dh, npos, d, window, literal)
    if args.tables:
        v1_table_parts(res, dev, *raw_rows(shards, dev), d, window, literal)
        return finish(res)
    blob = compress_sharded(data, shard_size=DEFAULT_SHARD_SIZE, device=dev)

    pk, tokens = cs.stream_tokens(dev, blob, window, literal, True)
    S, NBP = pk.shape
    max_out = dw._pow2_bucket(DEFAULT_SHARD_SIZE, 1024)
    out = torch.empty((S, 2), dtype=torch.int32, device=dev)
    res["b4_ms"], _ = ms_of(lambda: dc._launch(pk, d, d, W=W, more=False,
                                               max_out=max_out))
    res["b4_chain_ms"], _ = ms_of(lambda: _build.launch(
        "walk_probe", "tpt_probe_decode_chain", dev, (pk, out), (S, NBP)))
    if int(out[:, 0].sum()) != tokens:
        raise RuntimeError("the decode chain probe counted other tokens")
    for name, edit in ({} if args.no_variants else VARIANTS).items():
        fn = variant_lib(name, edit)
        o = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
        ln = torch.empty(S, dtype=torch.int32, device=dev)
        er = torch.empty(S, dtype=torch.int32, device=dev)
        args = [t.data_ptr() for t in (pk, d, d, o, ln, er)] + [
            S, NBP, window, 0, max_out,
            torch.cuda.current_stream().cuda_stream]
        res[name], _ = ms_of(lambda: _build.check(fn(*args), name))
        if name == "b4_batches":  # a count, not a time
            res[name] = int(er.sum())
    res["tokens"] = tokens
    del pk

    # B8 on the main path's per-bit parse, as phase 4 makes it
    from tamp_tpu_torch.ops.token_chase import token_table_chase
    from tamp_tpu_torch.parallel.shard import _parse_frame

    pieces = _parse_frame(blob)[2]
    nxt, _packed = dw.payload_parse([p[1:] for p in pieces], window=window,
                                    literal=literal, extended=True,
                                    device=dev)
    del _packed
    S, NBP = nxt.shape
    T_max = NBP // (1 + literal) + 2
    res["b8_ms"], (_st, T) = ms_of(lambda: token_table_chase(nxt, NBP,
                                                             T_max))
    res["b8_tokens"], res["b8_nbp"] = int(T.sum()), NBP
    res["b8_chain_ms"], _ = ms_of(lambda: _build.launch(
        "walk_probe", "tpt_probe_chase_chain", dev, (nxt, out), (S, NBP)))
    if int(out[:, 0].sum()) != res["b8_tokens"]:
        raise RuntimeError("the chase chain probe counted other tokens")
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    fold = torch.zeros(blocks, dtype=torch.int32, device=dev)
    res["b8_read_ms"], _ = ms_of(lambda: _build.launch(
        "walk_probe", "tpt_probe_read_plane", dev, (nxt, fold),
        (S * NBP, blocks)))
    res["b8_read_bytes"] = 4 * S * NBP
    res["b8_xla_ms"], (xs, xT) = ms_of(lambda: dw._token_table(
        nxt, NBP, literal, T_max))
    if not (torch.equal(xs, _st) and torch.equal(xT, T)):
        raise RuntimeError("the xla token table differs from B8's")
    del nxt, _st, T, xs, xT

    NP = dh.shape[1]
    npos_d = torch.from_numpy(npos).to(dev)
    _t, A, B = ext_fields(torch.from_numpy(dh).to(dev),
                          torch.from_numpy(rc).to(dev), npos_d, d,
                          window=window, literal=literal)
    del _t
    res["b3_ms"], _ = ms_of(lambda: commit_fields(
        A, B, npos_d, max_out=NP + NP // 8 + 64, idx_bits=0))
    res["b3_chain_ms"], _ = ms_of(lambda: _build.launch(
        "walk_probe", "tpt_probe_fields_chain", dev, (A, B, npos_d, out),
        (S, NP)))
    steps = cs.walk_count(B.cpu().numpy(), np.maximum(npos - 15, 0),
                          lambda m: (m >> 6) & 255)
    if int(out[:, 0].sum()) != steps:
        raise RuntimeError("the fields chain probe counted other steps")
    res["steps"] = steps
    del A, B, _p, dh, rc

    # B6 and B7 on the raw shards' tables, as phase 4 makes them
    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.ops.encode_commit import S_T, commit_v1_lazy
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.greedy_predict import P_T, greedy_predict_batch
    from tamp_tpu_torch.ops.match_v1 import v1_tables

    minp = compute_min_pattern_size(window, literal)
    raw_d, nraw_d = raw_rows(shards, dev)
    flen, fidx, plen, pidx = v1_tables(raw_d, nraw_d, d, window_bits=window,
                                       cap=v1_cap(window, literal), probe=True)
    v1_table_parts(res, dev, raw_d, nraw_d, d, window, literal)
    P = (flen << 23) | (fidx << 8) | raw_d.to(torch.int32)
    Q = (plen << 15) | pidx
    del flen, fidx, plen, pidx
    NR = P.shape[1]
    res["b6_ms"], (_o, st) = ms_of(lambda: commit_v1_lazy(
        P, Q, nraw_d, window=window, literal=literal,
        max_out=NR + NR // 8 + 64))
    res["b6_chain_ms"], _ = ms_of(lambda: _build.launch(
        "walk_probe", "tpt_probe_lazy_chain", dev, (P, Q, nraw_d, out),
        (S, NR, window, literal, minp)))
    if not torch.equal(out[:, 1], st[:, S_T]):
        raise RuntimeError("the lazy chain probe stopped elsewhere than B6")
    res["b6_steps"] = int(out[:, 0].sum())
    del P, Q, _o, st
    for lazy in (False, True):
        k = "b7_lazy" if lazy else "b7"
        pk, pp = cs.b7_inputs(raw_d, nraw_d, d, window=window, lazy=lazy)
        res[f"{k}_ms"], (_bm, _e, st) = ms_of(lambda: greedy_predict_batch(
            pk, pp, nraw_d, NP=NR, window=window, literal=literal,
            lazy=lazy))
        res[f"{k}_chain_ms"], _ = ms_of(lambda: _build.launch(
            "walk_probe", "tpt_probe_greedy_chain", dev,
            (pk, pp if lazy else pk, nraw_d, out),
            (S, NR, window, minp, int(lazy))))
        if not torch.equal(out[:, 1], st[:, P_T]):
            raise RuntimeError(f"the greedy chain probe stopped elsewhere "
                               f"than B7 (lazy={lazy})")
        res[f"{k}_steps"] = int(out[:, 0].sum())
        del pk, pp, _bm, _e, st
    for k in ("b4", "b3", "b6", "b7", "b7_lazy"):
        # a shard's walk: its steps are the total / S
        n = {"b4": tokens, "b3": steps}.get(k) or res[f"{k}_steps"]
        res[f"{k}_ns_per_step"] = res[f"{k}_ms"] * 1e6 * S / n
        res[f"{k}_chain_ns_per_step"] = res[f"{k}_chain_ms"] * 1e6 * S / n
    return finish(res)


def finish(res) -> int:
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res), flush=True)
    return 0


def x2_parts(res, dev, blob, d, window, literal):
    """X2 on the main path's payloads (as phase 4 decodes them) beside its
    variants (X2_VARIANTS), in ns a token a shard too."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.ops.decode_serial import padded_width, serial_decode
    from tamp_tpu_torch.parallel.shard import DEFAULT_SHARD_SIZE, _parse_frame

    pieces = _parse_frame(blob)[2]
    S = len(pieces)
    Lp = padded_width(max(len(p) - 1 for p in pieces))
    pl = np.zeros((S, Lp), np.uint8)
    for i, p in enumerate(pieces):
        pl[i, : len(p) - 1] = np.frombuffer(p[1:], np.uint8)
    pl_d = torch.from_numpy(pl).to(dev)
    nb_d = torch.tensor([len(p) - 1 for p in pieces], dtype=torch.int32,
                        device=dev)
    max_out = DEFAULT_SHARD_SIZE
    kw = dict(window=window, literal=literal, extended=True, more=False,
              max_out=max_out)
    res["x2_ms"], _r = cs.cuda_ms(
        lambda: serial_decode(pl_d, nb_d, d, d, **kw), reps=5)
    _pk, tokens = cs.stream_tokens(dev, blob, window, literal, True)
    del _pk
    res["x2_tokens"] = tokens
    res["x2_ns_per_token"] = res["x2_ms"] * 1e6 * S / tokens
    minp = compute_min_pattern_size(window, literal)
    for name, edit in X2_VARIANTS.items():
        fn = variant_lib(name, edit, "decode_serial", "tpt_serial_decode",
                         7, 8)
        o = torch.zeros((S, max_out), dtype=torch.uint8, device=dev)
        ln = torch.empty(S, dtype=torch.int32, device=dev)
        er = torch.empty(S, dtype=torch.int32, device=dev)
        argv = [t.data_ptr() for t in (pl_d, nb_d, d, d, o, ln, er)] + [
            S, Lp, window, literal, 1, 0, minp, max_out,
            torch.cuda.current_stream().cuda_stream]
        res[name], _ = cs.cuda_ms(lambda: _build.check(fn(*argv), name),
                                  reps=5)
        res[name.replace("_ms", "_ns_per_token")] = (
            res[name] * 1e6 * S / tokens)


def x4_parts(res, dev, shards, window, literal):
    """X4 on the optimal path's planes (as phase 4 makes them): the whole
    call, each of its three launches (profiler), and the pass-1 variants
    (X4_VARIANTS) by launch."""
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.engine.pipeline_ext import (
        optimal_batch, optimal_prep,
    )
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.ops.opt_parse import block_size
    from tamp_tpu_torch.ops.opt_parse_ext import (
        B_EXT, chunk_weights, opt_ext_choice,
    )

    kw = dict(window=window, literal=literal)
    planes = optimal_batch(shards, optimal_prep(shards, **kw),
                           literal=literal)
    args = cs.on_device(dev, planes)
    parts = {k.replace(" ", ""): v for k, v in cs.X4_LAUNCHES.items()}
    res["x4_ms"], (choice, _c, _b) = cs.cuda_ms(
        lambda: opt_ext_choice(*args, **kw), reps=5)
    for k, v in cs.launch_split(lambda: opt_ext_choice(*args, **kw),
                                parts).items():
        res[f"x4_{k}_ms"] = v
    pk, data, npos, sp, sc = args
    S, NP = pk.shape
    B = block_size(NP, B_EXT)
    K = 131 + (2 if window <= 10 + ((literal - 5) << 1) else 3)
    cw = chunk_weights(sp, sc, NP)
    n_b = NP // B
    for name, (launch, edit) in X4_VARIANTS.items():
        fn = variant_lib(name, edit, "opt_parse", "tpt_opt_ext_choice", 9, 5)
        ch = torch.empty((S, NP), dtype=torch.uint8, device=dev)
        c0 = torch.empty(S, dtype=torch.int32, device=dev)
        bad = torch.zeros(S, dtype=torch.int32, device=dev)
        T = torch.empty(S * n_b * ((K * K + 3) & ~3), dtype=torch.int32,
                        device=dev)
        bounds = torch.empty(S * n_b * K, dtype=torch.int32, device=dev)
        argv = [None if t is None else t.data_ptr() for t in (
            pk, data, npos, cw, ch, c0, bad, T, bounds)] + [
            S, NP, B, window, literal,
            torch.cuda.current_stream().cuda_stream]
        try:
            split = cs.launch_split(lambda: _build.check(fn(*argv), name),
                                    {launch: launch})
            res[name] = split[launch]
        except RuntimeError as e:  # a variant the card refuses to launch
            res[name] = f"failed: {e}"
    del choice
    # the same planes at a block size of 4096 (the output must not change)
    from tamp_tpu_torch.ops import opt_parse_ext

    kept = opt_parse_ext.B_EXT
    opt_parse_ext.B_EXT = 4096
    try:
        res["x4_b4096_ms"], got = cs.cuda_ms(
            lambda: opt_ext_choice(*args, **kw), reps=5)
        for k, v in cs.launch_split(lambda: opt_ext_choice(*args, **kw),
                                    parts).items():
            res[f"x4_b4096_{k}_ms"] = v
    finally:
        opt_parse_ext.B_EXT = kept
    ref = opt_ext_choice(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise RuntimeError("X4 at B = 4096 differs from X4 at its block size")
    del got, ref


def x3_parts(res, dev, shards, window, literal):
    """X3 on the optimal v1 path's inputs (B5's tables of the raw shards,
    as phase 4 makes them): the whole call and each launch (profiler,
    chip_smoke.X3_LAUNCHES), the share of in-shard positions with a match
    (flen >= minp) and their mean highest advance, the launches at other
    block sizes (``x3_b{B}_*``; the choices must not change) and the
    variants (X3_VARIANTS) by launch."""
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.match_v1 import v1_tables
    from tamp_tpu_torch.ops.opt_parse import K_V1, opt_v1_choice, v1_block

    raw_d, nraw_d = raw_rows(shards, dev)
    dict1 = torch.from_numpy(dictionary_array(1 << window, 8)).to(dev)
    flen = v1_tables(raw_d, nraw_d, dict1, window_bits=window,
                     cap=v1_cap(window, literal))[0]
    kw = dict(window=window, literal=literal)
    res["x3_ms"], want = cs.cuda_ms(
        lambda: opt_v1_choice(flen, raw_d, nraw_d, **kw), reps=5)
    labels = {k.replace(" ", ""): v for k, v in cs.X3_LAUNCHES.items()}
    for k, v in cs.launch_split(lambda: opt_v1_choice(flen, raw_d, nraw_d,
                                                      **kw), labels).items():
        res[f"x3_{k}_ms"] = v
    minp = compute_min_pattern_size(window, literal)
    S, NP = flen.shape
    inside = torch.arange(NP, device=dev)[None, :] < nraw_d[:, None]
    m = inside & (flen >= minp)
    res["x3_match_share"] = int(m.sum()) / int(inside.sum())
    res["x3_mean_hi"] = float(flen[m].double().mean())

    def split(fn, B, parts, check=True):
        """fn (a tpt_opt_v1_choice) at block size B: ms by launch (and
        whether its choices differ from the wrapper's)."""
        n_b = NP // B
        ch = torch.empty((S, NP), dtype=torch.int32, device=dev)
        out = (ch, torch.empty(S, dtype=torch.int32, device=dev),
               torch.zeros(S, dtype=torch.int32, device=dev),
               torch.empty(S * n_b * K_V1 * K_V1, dtype=torch.int32,
                           device=dev),
               torch.empty(S * n_b * K_V1, dtype=torch.int32, device=dev))
        argv = [t.data_ptr() for t in (flen, raw_d, nraw_d, *out)] + [
            S, NP, B, window, literal,
            torch.cuda.current_stream().cuda_stream]
        got = cs.launch_split(lambda: _build.check(fn(*argv), "X3"), parts)
        if check and not torch.equal(ch, want[0]):
            raise RuntimeError(f"X3 at B = {B} differs from its wrapper's")
        return got, not torch.equal(ch, want[0])

    main = getattr(_build.load("opt_parse"), "tpt_opt_v1_choice")
    main.restype = ctypes.c_int
    main.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    for B in X3_BLOCK_SIZES:
        if B != v1_block(NP):
            for k, v in split(main, B, labels)[0].items():
                res[f"x3_b{B}_{k}_ms"] = v
    for name, (launches, edit) in X3_VARIANTS.items():
        fn = variant_lib(name, edit, "opt_parse", "tpt_opt_v1_choice", 8, 5)
        got, differs = split(fn, v1_block(NP),
                             {k: labels[k] for k in launches}, check=False)
        res[name] = sum(got.values())
        if len(got) > 1:
            for k, v in got.items():
                res[name.replace("_ms", f"_{k}_ms")] = v
        if differs:
            res[name.replace("_ms", "_differs")] = True
    del flen, want


def x1_parts(res, dev, blob, window, literal):
    """X1 on the main path's token table (the chase's, as phase 4 folds
    it): the call, its kernel alone (profiler), ns a truncating token (of
    all shards and a shard), the count of nonzero deficits, and the
    one-thread chain over the same rows staged in shared memory
    (``tpt_probe_trunc_chain`` of csrc/walk_probe.cu), and the variants
    (X1_VARIANTS)."""
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.ops import _build
    from tamp_tpu_torch.ops import decode_wavefront as dw
    from tamp_tpu_torch.ops.token_chase import token_table_chase
    from tamp_tpu_torch.parallel.shard import _parse_frame

    pieces = _parse_frame(blob)[2]
    nxt, packed = dw.payload_parse([p[1:] for p in pieces], window=window,
                                   literal=literal, extended=True,
                                   device=dev)
    S, NBP = nxt.shape
    T_max = NBP // (1 + literal) + 2
    tab = token_table_chase(nxt, NBP, T_max)
    x1_in = dw.fold_inputs(*tab, packed, more=False)
    del nxt, packed, tab
    W = 1 << window
    res["x1_ms"], defs = cs.cuda_ms(lambda: dw.trunc_deficits(*x1_in, W),
                                    reps=5)
    res["x1_kernel_ms"] = cs.launch_split(
        lambda: dw.trunc_deficits(*x1_in, W),
        {"fold": "trunc_deficits"})["fold"]
    n_tr = int(x1_in[3].sum())
    res["x1_n_tr"], res["x1_t_max"] = n_tr, T_max
    res["x1_n_tr_by_shard"] = x1_in[3].tolist()
    res["x1_nonzero"] = int((defs != 0).sum())
    out = torch.zeros_like(defs)
    res["x1_chain_ms"] = cs.launch_split(lambda: _build.launch(
        "walk_probe", "tpt_probe_trunc_chain", dev, (*x1_in, out),
        (S, T_max, W)), {"chain": "probe_trunc_chain"})["chain"]
    if not torch.equal(out, defs):
        raise RuntimeError("the fold chain probe differs from X1")
    for name, edit in X1_VARIANTS.items():
        fn = variant_lib(name, edit, "decode_wavefront", "tpt_trunc_deficits",
                         5, 3)
        out.zero_()
        argv = [t.data_ptr() for t in (*x1_in, out)] + [
            S, T_max, W, torch.cuda.current_stream().cuda_stream]
        res[name] = cs.launch_split(lambda: _build.check(fn(*argv), name),
                                    {"fold": "trunc_deficits"})["fold"]
        if not torch.equal(out, defs):
            res[name.replace("_ms", "_differs")] = True
    for k in ("x1_ms", "x1_kernel_ms", "x1_chain_ms", *X1_VARIANTS):
        ns = res[k] * 1e6 / max(n_tr, 1)
        res[k.replace("_ms", "_ns_per_token")] = ns
        res[k.replace("_ms", "_ns_per_token_a_shard")] = ns * S


def table_parts(res, key, dev, rows, npos_d, d, window, lrun, probe):
    """The first port's table skeleton with parts cut out (probe_tables of
    csrc/walk_probe.cu) on ``rows``: ``{key}_stage_ms`` and
    ``{key}_first_byte_ms``, and without the probe family the counts of
    (position, slot) pairs matching 1, 2 and 16 bytes (runs capped at
    ``lrun``) and the lengths past 16."""
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.ops import _build

    S, MP = rows.shape
    planes = [torch.empty((S, MP), dtype=torch.int32, device=dev)
              for _ in range(4)]
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    for mode, part in ((0, "stage"), (1, "first_byte")):
        res[f"{key}_{part}_ms"], _ = cs.cuda_ms(lambda: _build.launch(
            "walk_probe", "tpt_probe_tables", dev,
            (rows, npos_d, d, *planes, counts),
            (S, MP, window, int(probe), mode, lrun)), reps=5)
    if probe:
        return None
    _build.launch("walk_probe", "tpt_probe_tables", dev,
                  (rows, npos_d, d, *planes, counts),
                  (S, MP, window, 0, 2, lrun))
    return [int(c) for c in counts.tolist()]


def ext_table_parts(res, dev, dh, npos, d, window, literal):
    """B1 and B2 on the model history ``dh`` (S, NP) beside the skeleton's
    parts there, and the shares of pairs matching 1, 2 and 16 bytes."""
    import torch

    import chip_smoke as cs
    from tamp_tpu_torch.constants import compute_min_pattern_size
    from tamp_tpu_torch.ops.match_ext import ext_tables, ext_tables_probe

    lext = compute_min_pattern_size(window, literal) + 131
    dh_d = torch.from_numpy(dh).to(dev)
    npos_d = torch.from_numpy(npos).to(dev)
    kw = dict(window_bits=window, LEXT=lext)
    res["b1_ms"], _ = cs.cuda_ms(lambda: ext_tables(dh_d, npos_d, d, **kw),
                                 reps=5)
    res["b2_ms"], _ = cs.cuda_ms(lambda: ext_tables_probe(dh_d, npos_d, d,
                                                          **kw), reps=5)
    res["b1_npos"], res["b1_np"] = int(npos.sum()), dh.shape[1]
    n1, n2, n16, past = table_parts(res, "b1", dev, dh_d, npos_d, d, window,
                                    lext, False)
    table_parts(res, "b2", dev, dh_d, npos_d, d, window, lext, True)
    pairs = int(npos.astype("int64").sum()) << window
    res["b1_pairs"] = pairs
    res["b1_share_1"], res["b1_share_2"] = n1 / pairs, n2 / pairs
    res["b1_share_16"] = n16 / pairs
    res["b1_mean_past_16"] = past / max(n16, 1)


def raw_rows(shards, dev):
    """The raw shards as (S, shard size) uint8 rows on ``dev`` and their
    (S,) int32 lengths."""
    import numpy as np
    import torch

    from tamp_tpu_torch.parallel.shard import DEFAULT_SHARD_SIZE

    raw = np.zeros((len(shards), DEFAULT_SHARD_SIZE), np.uint8)
    for i, x in enumerate(shards):
        raw[i, : x.shape[0]] = x
    return (torch.from_numpy(raw).to(dev),
            torch.tensor([x.shape[0] for x in shards], dtype=torch.int32,
                         device=dev))


def v1_table_parts(res, dev, raw_d, nraw_d, d, window, literal):
    """B5 on the raw shards (rows ``raw_d``, lengths ``nraw_d``), without
    and with the probe, beside the skeleton's parts there, and the shares
    of pairs matching 1 and 2 bytes."""
    import chip_smoke as cs
    from tamp_tpu_torch.ops.encode_fused import v1_cap
    from tamp_tpu_torch.ops.match_v1 import v1_tables

    b5_kw = dict(window_bits=window, cap=v1_cap(window, literal))
    res["b5_ms"], _ = cs.cuda_ms(lambda: v1_tables(raw_d, nraw_d, d,
                                                   **b5_kw), reps=5)
    res["b5_probe_ms"], _ = cs.cuda_ms(lambda: v1_tables(
        raw_d, nraw_d, d, probe=True, **b5_kw), reps=5)
    n1, n2, _n16, _past = table_parts(res, "b5", dev, raw_d, nraw_d, d,
                                      window, 16, False)
    table_parts(res, "b5_probe", dev, raw_d, nraw_d, d, window, 16, True)
    pairs = int(nraw_d.sum()) << window
    res["b5_pairs"] = pairs
    res["b5_share_1"], res["b5_share_2"] = n1 / pairs, n2 / pairs


if __name__ == "__main__":
    sys.exit(main())

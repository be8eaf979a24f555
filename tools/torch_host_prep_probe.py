#!/usr/bin/env python3
"""Host half of the default device encode, taken apart on one machine.

    python3 tools/torch_host_prep_probe.py [--mb 8] [--shard-kib 1024]
        [--reps 7] [--device cpu]

The main path (``compress_sharded(engine="device-commit")``) runs the C++
prep (engine/greedy.host_ext_prep) over its shards before the card and
the C++ tail walk (host_ext_tail_bits) after it: the prep a thread a
shard through engine/pipeline.per_shard, the tails one after another.  This prints, as the median (min-max)
of ``--reps`` host-clock runs after a warm-up, for the batch of
``--mb`` MiB of bench_torch.build_corpus in ``--shard-kib`` shards:

- ``pool``: per_shard of a no-op over the shards (the thread pool alone);
- the prep: the C entry alone on buffers allocated once (one thread),
  host_ext_prep one shard after another on the calling thread, in a pool
  a shard (per_shard; prepare_batch adds the padded planes), and the
  NumPy plain version one shard after another;
- the tails, from the commit state of one device stage on ``--device``:
  the C entry alone on an output allocated once, ext_tails (one shard
  after another) and host_ext_tail_bits in a pool a shard (per_shard);
- the machine's memory: fresh pages touched (``np.ones`` of the batch's
  size), and 256 KiB blocks (a tail's pair-chain heads) allocated,
  touched and freed, a shard's worth.

The prep's outputs are held equal to the plain version's and the tails'
to each other, so a wrong copy fails here before it is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn, reps: int):
    """(median, min, max) host ms of ``fn()`` over ``reps`` runs after one
    warm-up, and its last result."""
    out = fn()
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return (statistics.median(ms), min(ms), max(ms)), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--shard-kib", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bench_torch import build_corpus, smi
    from tamp_tpu_torch.device import resolve_device
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine import greedy
    from tamp_tpu_torch.engine.pipeline import per_shard
    from tamp_tpu_torch.engine.pipeline_ext import (
        ext_device_stage, ext_tails, prepare_batch, resume_position,
    )
    from tamp_tpu_torch.engine.plan import ext_prep
    from tamp_tpu_torch.ops.encode_commit import S_ACC, S_AN, S_T

    window, literal = 10, 8
    dev = resolve_device(args.device)
    where = smi() if dev.type == "cuda" else "cpu (plain versions)"
    print(where, flush=True)
    size = args.shard_kib << 10
    data = build_corpus(int(args.mb * (1 << 20)))
    shards = [np.frombuffer(data[i : i + size], np.uint8)
              for i in range(0, len(data), size)]
    S, reps = len(shards), args.reps

    def line(name, t):
        print(f"  {name}: {t[0]:.3f} ms ({t[1]:.3f}-{t[2]:.3f}) [{where}]",
              flush=True)

    line(f"pool, a no-op a shard ({S} shards)",
         timed(lambda: per_shard(lambda i: None, S), reps)[0])

    # the C entry on buffers allocated once: the copy's own work
    entry = greedy._host_entry("tpt_ext_prep")
    bufs = []
    for x in shards:
        n = x.shape[0]
        bufs.append((np.zeros((n // 9 + 2, 2), np.int64),
                     np.zeros(n + 1, np.uint32), np.zeros(max(n, 1), np.uint8),
                     np.zeros(max(n, 1), np.uint8)))
    n_plans, dh_len = ctypes.c_int64(0), ctypes.c_int64(0)

    def raw():
        for x, (pl, kh, dh, rc) in zip(shards, bufs):
            code = entry(x.ctypes.data, x.shape[0], window, pl.ctypes.data,
                         pl.shape[0], ctypes.addressof(n_plans),
                         kh.ctypes.data, dh.ctypes.data, rc.ctypes.data,
                         ctypes.addressof(dh_len))
            if code:
                raise RuntimeError(f"tpt_ext_prep rc={code}")

    line("prep, C entry alone, buffers allocated once, one thread",
         timed(raw, reps)[0])
    t, serial = timed(lambda: [greedy.host_ext_prep(x, window)
                               for x in shards], reps)
    line("prep, host_ext_prep one shard after another", t)
    t, pooled = timed(lambda: per_shard(
        lambda i: greedy.host_ext_prep(shards[i], window), S), reps)
    line("prep, host_ext_prep a thread a shard (per_shard)", t)
    line("prep, prepare_batch (per_shard + padded planes)",
         timed(lambda: prepare_batch(shards, window=window), reps)[0])
    t, plain = timed(lambda: [ext_prep(x, window) for x in shards],
                     max(1, reps // 2))
    line("prep, NumPy engine/plan.ext_prep one shard after another", t)
    for got in (serial, pooled):
        for a, b in zip(got, plain):
            if not all(u.dtype == v.dtype and np.array_equal(u, v)
                       for u, v in zip(a, b)):
                raise SystemExit("host_ext_prep differs from plan.ext_prep")

    prep, dh, rc, npos = prepare_batch(shards, window=window)
    dict_arr = dictionary_array(1 << window, literal)
    _out, state = ext_device_stage(
        torch.from_numpy(dh).to(dev), torch.from_numpy(rc).to(dev),
        torch.from_numpy(npos).to(dev), torch.from_numpy(dict_arr).to(dev),
        window=window, literal=literal)
    state = state.cpu().numpy()
    kw = dict(window=window, literal=literal, lazy=False, dict_arr=dict_arr)
    tail_entry = greedy._host_entry("tpt_ext_tail_bits")
    out = np.zeros(1 << 16, np.uint8)
    out_len = ctypes.c_int64(0)
    resume = []
    for i, x in enumerate(shards):
        plans, khat, dhi, _rc = prep[i]
        t_in = resume_position(khat, int(state[i][S_T]), dhi.shape[0])
        pl = plans.reshape(-1) if plans.size else np.zeros(2, np.int64)
        resume.append((x, t_in, dhi, khat, pl, plans.shape[0],
                       int(state[i][S_ACC]), int(state[i][S_AN])))

    def raw_tails():
        for x, t_in, dhi, khat, pl, n_plan, acc, an in resume:
            code = tail_entry(
                x.ctypes.data, x.shape[0], t_in, dhi.ctypes.data,
                khat.ctypes.data, pl.ctypes.data, n_plan,
                dict_arr.ctypes.data, window, literal, 0, acc, an,
                out.ctypes.data, out.shape[0], ctypes.addressof(out_len))
            if code:
                raise RuntimeError(f"tpt_ext_tail_bits rc={code}")

    line("tails, C entry alone, output allocated once, one thread",
         timed(raw_tails, reps)[0])
    t, one = timed(lambda: ext_tails(shards, prep, state, **kw), reps)
    line("tails, ext_tails (one shard after another)", t)
    # a batch of one runs on the calling thread (per_shard)
    t, many = timed(lambda: per_shard(lambda i: ext_tails(
        [shards[i]], [prep[i]], state[i : i + 1], **kw)[0], S), reps)
    line("tails, a thread a shard (per_shard)", t)
    if one != many:
        raise SystemExit("the tails differ between one thread and many")

    nbytes = sum(x.shape[0] for x in shards)
    line(f"memory, np.ones of {nbytes} bytes (fresh pages, touched)",
         timed(lambda: np.ones(nbytes, np.uint8), reps)[0])
    line(f"memory, {S} x np.ones of 256 KiB (allocated, touched, freed)",
         timed(lambda: [np.ones(1 << 16, np.int32).sum() for _ in range(S)],
               reps)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (tamp_tpu_torch) on one
NVIDIA card: the counterpart of bench.py, with its geometry and key names.

    python3 bench_torch.py [--mb 48] [--device-mb 8] [--corpus text|match]
        [--window 10] [--seed N] [--reps 5] [--workers N]
        [--stages decode,v1_encode,...] [--profile] [--device cpu]

Legs (the kernels each runs on the card in brackets):

- headline, bench.py's host line, on ``--mb`` MiB in 1 MiB shards:
  ``compress_sharded`` with the default engine ``"native"`` (``value``;
  B5, B7 and the host greedy committer), ``decompress_sharded``
  (``decode_mb_s``; X2, ``2 * workers`` shards a launch) and
  ``compress_sharded(engine="optimal")`` (``optimal_mb_s``; the host tables
  and walk around X4);
- the device stages, bench.py's device section, on a ``--device-mb`` batch:
  ``decode`` (``decompress_sharded_device`` of the ``"native"`` container
  in mode ``commit``, B4, passed explicitly so that ``TAMP_TPU_DECODE``
  picks nothing, then ``chase`` (B8, X1), ``xla`` (X1) and
  ``algorithm="serial"`` (X2)), ``v1_encode`` (``device-commit`` v1: B5,
  B3), ``ext_encode`` (``device-commit`` extended, the main path: B1,
  B3), ``greedy_encode`` (``device-greedy``: B5, B7), ``optimal_encode``
  (``device-optimal`` v1: B5, X3, B3) and ``compute``
  (tools/torch_commit_kernel_bench.py: B4 and B3 alone).

Checks, all before any leg is timed (a failure raises and the run exits
nonzero with no rate): every container decodes to its input through X2
(``decompress_sharded``) and through the host C++ stream decoder
(``stream.NativeDecompressor``), which shares no code with the card's
decoders; the shards of the greedy (``"native"``, ``device-greedy``) and
v1 containers equal the host C++ stream encoder's (``stream.
NativeCompressor``, the reference greedy encoder); the optimal v1 shards
equal the host minimum-bit parse (``engine/greedy.host_optimal_v1``) and
their container is no larger than the v1 greedy one; every decode leg
gives its input back.

Timing: one warm-up call a leg with its checks (its launch counts are the
leg's); then ``--reps`` calls, each a host clock around a call that ends in
``torch.cuda.synchronize()``.  A rate is the median call's (bench.py took
the best of N; the median with its min and max, ``<key>_spread``, rides
out host stages that move by tens of percent a run); ``<key>_peak_gib``
is the leg's peak device memory.  ``setup_s`` is the kernels' build,
``checks_s`` the warm-up and check pass.  ``--profile`` adds one untimed
call a leg under torch.profiler and prints its device idle share and five
largest kernels.

Output: progress lines, then as the last line one JSON object: bench.py's
keys, the device stages' keys beside them, and ``device`` (the card's
name, the count and nvidia-smi's name and power limit).  Without a card the
bench exits nonzero and prints no rate; ``--device cpu`` runs the kernels'
plain versions at tiny sizes (a rehearsal for the tests), its line says
``"platform": "cpu"`` and its metric "CPU rehearsal".  Every corpus is
made from ``--seed``; nothing is read from disk.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the reference C library's published single-core enwik8 rates (its
# README), bench.py's baselines: neither a card nor a TPU number
BASELINE_ENCODE_MBS = 18.3
BASELINE_DECODE_MBS = 184.0
SEED = 0x7A3B
CORPORA = {"text": 512, "match": 48}  # kind: vocabulary (seeded words)
STAGES = ("decode", "v1_encode", "ext_encode", "greedy_encode",
          "optimal_encode", "compute")
MODES = ("commit", "chase", "xla")
COMPUTE_MB = 2.0  # the compute stage's stream (bench.py's measure(2.0, 2))
LITERAL = 8


def build_corpus(size: int, seed: int = SEED, kind: str = "text") -> bytes:
    """A seeded text of ``size`` bytes: draws from a vocabulary of random
    lower-case words (2-9 letters, uint8), space-separated and repeated.
    ``"text"``: 200 000 draws from 512 words with a run-heavy stretch of
    1/16 of the size in its middle, so that forced RLE regions occur
    (ratio ~0.61 at w10 l8; chip_smoke.py's corpus).  ``"match"``: draws
    from 48 words, a vocabulary that fits a 1 KiB window, no runs."""
    import numpy as np

    if kind not in CORPORA:
        raise ValueError(f"unknown corpus {kind!r}: one of {tuple(CORPORA)}")
    vocab = CORPORA[kind]
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10)).astype(np.uint8)
             .tobytes() for _ in range(vocab)]
    base = b" ".join(words[int(i) % vocab]
                     for i in rng.integers(0, vocab, 200_000))
    text = (base * (-(-size // len(base))))[:size]
    if kind == "match":
        return text
    runs = b"".join(bytes([int(b)]) * int(c) for b, c in zip(
        rng.integers(0, 256, 4096), rng.integers(1, 400, 4096)))
    mid = size // 2
    stretch = runs[: size // 16]
    return text[:mid] + stretch + text[mid + len(stretch):]


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from tamp_tpu_torch.ops import decode_commit as dc
    from tamp_tpu_torch.ops.decode_serial import serial_decode
    from tamp_tpu_torch.ops.decode_wavefront import (
        parse_words, trunc_deficits,
    )
    from tamp_tpu_torch.ops.encode_commit import commit_fields, commit_v1_lazy
    from tamp_tpu_torch.ops.greedy_predict import greedy_predict_batch
    from tamp_tpu_torch.ops.match_ext import ext_tables, ext_tables_probe
    from tamp_tpu_torch.ops.match_v1 import v1_tables
    from tamp_tpu_torch.ops.opt_parse import opt_v1_choice
    from tamp_tpu_torch.ops.opt_parse_ext import opt_ext_choice
    from tamp_tpu_torch.ops.token_chase import token_table_chase

    fns = (ext_tables, ext_tables_probe, commit_fields, dc.commit_decode,
           v1_tables, commit_v1_lazy, token_table_chase, trunc_deficits,
           serial_decode, greedy_predict_batch, opt_v1_choice,
           opt_ext_choice, parse_words)
    return {fn.__name__: fn for fn in fns}


def idle_share(report, name: str, fn, card: str, warm: bool = True) -> float:
    """Device busy time and idle share of one call of ``fn`` (after a warm
    call unless ``warm`` is False), from a torch.profiler trace: the device
    activity (kernels and copies) summed over the call's wall time;
    reports the five largest device rows and returns the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise RuntimeError(f"the profiler saw no device activity in the "
                           f"{name}")
    report(f"  profile {name}: wall {wall:.1f} ms, device busy "
           f"{busy:.1f} ms, idle share {1 - busy / wall:.3f} [{card}]")
    for ms, key, count in sorted(rows, reverse=True)[:5]:
        report(f"    {ms:8.3f} ms x{count} {key[:80]}")
    return 1 - busy / wall


def fail(msg: str):
    raise RuntimeError(f"bench_torch: {msg}")


class Leg:
    """One timed call: ``key`` names its rate, ``nbytes`` the raw bytes a
    call handles; ``check(result)`` runs once on the warm-up call's
    result, before any leg is timed."""

    def __init__(self, key: str, nbytes: int, fn, check):
        self.key, self.nbytes, self.fn, self.check = key, nbytes, fn, check
        self.launches: dict = {}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float,
                    default=float(os.environ.get("BENCH_MB", "48")),
                    help="headline size in MiB (default 48, or BENCH_MB)")
    ap.add_argument("--device-mb", type=float, default=8.0,
                    help="the device stages' batch in MiB (default 8)")
    ap.add_argument("--shard-kib", type=int, default=1024,
                    help="shard size in KiB (default 1024)")
    ap.add_argument("--corpus", choices=tuple(CORPORA), default="text")
    ap.add_argument("--window", type=int, choices=range(8, 16), default=10)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--workers", type=int,
                    default=(os.cpu_count() or 4) + 2,
                    help="decompress_sharded's workers (2 * workers shards "
                         "an X2 launch) and the checks' threads")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"device stages, a subset of {','.join(STAGES)}")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the kernels' plain versions, a rehearsal")
    args = ap.parse_args(argv)
    args.stages = [s for s in args.stages.split(",") if s]
    bad = [s for s in args.stages if s not in STAGES]
    if bad:
        ap.error(f"unknown stages {bad}: a subset of {STAGES}")
    if args.reps < 1 or args.workers < 1 or args.shard_kib < 1:
        ap.error("--reps, --workers and --shard-kib must be positive")
    if args.profile and args.device == "cpu":
        ap.error("--profile needs the card")
    return args


def run(args, report) -> dict:
    """Build the corpora, check every leg, time it, and return the line."""
    import torch

    from tamp_tpu_torch.cli.main import (
        get_compress_implementation, get_decompress_implementation,
    )
    from tamp_tpu_torch.engine.greedy import host_optimal_v1
    from tamp_tpu_torch.parallel.shard import (
        _parse_frame, compress_sharded, decompress_sharded,
        decompress_sharded_device,
    )
    from tools.torch_commit_kernel_bench import prepare, timings

    t_run = time.perf_counter()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = smi() if cuda else "cpu (plain versions)"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    report(f"bench_torch: {card}; torch {torch.__version__}")
    setup_s = 0.0
    if cuda:
        from tamp_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.build_all()
        setup_s = time.perf_counter() - t
        report(f"  kernels built in {setup_s:.2f} s")

    w, workers, shard = args.window, args.workers, args.shard_kib << 10
    cfg = dict(window=w, literal=LITERAL, shard_size=shard, device=dev)
    encode_native = get_compress_implementation("native")
    decode_native = get_decompress_implementation("native")
    line: dict = {}

    def pmap(fn, items):
        """``fn`` over ``items`` on ``workers`` threads (the host C++
        calls release the GIL)."""
        with ThreadPoolExecutor(workers) as pool:
            return list(pool.map(fn, items))

    def shards_of(blob):
        return _parse_frame(blob)[2]

    def round_trip(name, blob, data):
        """The container back through X2 and the host C++ decoder."""
        try:
            back = decompress_sharded(blob, workers, device=dev)
            host = b"".join(pmap(decode_native, shards_of(blob)))
        except ValueError as e:  # OutOfBoundsError included
            fail(f"{name}: the container does not decode: {e!r}")
        if back != data or host != data:
            fail(f"{name}: the container decodes to other bytes (X2 "
                 f"{back == data}, host C++ decoder {host == data})")

    def reference(data, fn):
        pieces = [data[i : i + shard] for i in range(0, len(data), shard)]
        return pmap(fn, pieces or [b""])

    def equal_shards(name, blob, want, what):
        got = shards_of(blob)
        bad = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
        if bad or len(got) != len(want):
            fail(f"{name}: shards {bad[:8]} differ from {what}")

    def greedy_ref(data, extended=True):
        return reference(data, lambda p: encode_native(
            p, window=w, literal=LITERAL, extended=extended))

    def encode_leg(key, data, ratio_key, refs=(), flag=None, most=None,
                   **kw):
        """A container encode of ``data``: its round trip, its shards
        equal to each ``(streams(), what)`` of ``refs`` (then ``flag`` is
        set to 1), its streams' total no larger than ``most``'s (where
        given), and its size as ``ratio_key``."""
        def check(blob):
            round_trip(key, blob, data)
            for want, what in refs:
                equal_shards(key, blob, want(), what)
            got = sum(len(p) for p in shards_of(blob))
            if most is not None and got > sum(len(p) for p in most):
                fail(f"{key}: {got} stream bytes, more than the v1 greedy "
                     f"streams' {sum(len(p) for p in most)}")
            if flag:
                line[flag] = 1
            line[ratio_key] = len(blob) / len(data)
        return Leg(key, len(data),
                   lambda: compress_sharded(data, **cfg, **kw), check)

    def decode_leg(key, data, blob, fn):
        def check(out):
            if bytes(out) != data:
                fail(f"{key}: the decode differs from the input")
        return Leg(key, len(data), lambda: fn(blob), check)

    t = time.perf_counter()
    data = build_corpus(int(args.mb * (1 << 20)), args.seed, args.corpus)
    report(f"  {args.corpus} corpus of {len(data)} bytes (seed {args.seed}) "
           f"in {time.perf_counter() - t:.2f} s, zero-byte share "
           f"{data.count(0) / max(1, len(data)):.4f}")
    head = compress_sharded(data, workers=workers, **cfg)
    legs = [
        encode_leg("value", data, "ratio",
                   [(lambda: greedy_ref(data), "the reference greedy "
                     "encoder's (stream.NativeCompressor)")],
                   workers=workers),
        decode_leg("decode_mb_s", data, head,
                   lambda b: decompress_sharded(b, workers, device=dev)),
        encode_leg("optimal_mb_s", data, "optimal_ratio", engine="optimal"),
    ]
    dev_data = build_corpus(int(args.device_mb * (1 << 20)), args.seed,
                            args.corpus)
    if "decode" in args.stages:
        blob = compress_sharded(dev_data, **cfg)
        round_trip("device batch", blob, dev_data)
        line["container_decode_mode"] = "commit"
        for mode in MODES:
            key = ("container_decode_mb_s" if mode == "commit" else
                   f"container_decode_{mode}_mb_s")
            legs.append(decode_leg(key, dev_data, blob, lambda b, m=mode:
                                   decompress_sharded_device(b, device=dev,
                                                             mode=m)))
        legs.append(decode_leg(
            "container_decode_serial_mb_s", dev_data, blob,
            lambda b: decompress_sharded_device(b, algorithm="serial",
                                                device=dev)))
    v1_refs = []
    if {"v1_encode", "optimal_encode"} & set(args.stages):
        v1_refs = greedy_ref(dev_data, extended=False)
    if "v1_encode" in args.stages:
        legs.append(encode_leg(
            "v1_encode_mb_s", dev_data, "v1_ratio",
            [(lambda: v1_refs, "the reference v1 encoder's")],
            engine="device-commit", extended=False))
    if "ext_encode" in args.stages:
        legs.append(encode_leg("ext_encode_mb_s", dev_data, "ext_ratio",
                               engine="device-commit"))
    if "greedy_encode" in args.stages:
        legs.append(encode_leg(
            "greedy_encode_mb_s", dev_data, "greedy_ratio",
            [(lambda: greedy_ref(dev_data), "the reference greedy "
              "encoder's")], flag="greedy_byte_equal_reference",
            engine="device-greedy"))
    if "optimal_encode" in args.stages:
        legs.append(encode_leg(
            "optimal_encode_mb_s", dev_data, "optimal_v1_ratio",
            [(lambda: reference(dev_data, lambda p: host_optimal_v1(
                p, window=w, literal=LITERAL)), "the host DP's")],
            flag="optimal_byte_equal_host_dp", most=v1_refs,
            engine="device-optimal", extended=False))
    line["device_batch_mb"] = args.device_mb

    fns = counters()
    t = time.perf_counter()
    for leg in legs:
        for fn in fns.values():
            fn.launches = 0
        out = leg.fn()
        leg.launches = {k: fn.launches for k, fn in fns.items()
                        if fn.launches}
        leg.check(out)
        report(f"  {leg.key}: checked; launches {leg.launches}")
    compute = None
    if "compute" in args.stages:
        compute = prepare(min(COMPUTE_MB, args.device_mb), window=w,
                          device=dev)
        report("  compute: checked")
    checks_s = time.perf_counter() - t
    report(f"  every check passed in {checks_s:.1f} s; timing")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for leg in legs:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(args.reps):
            sync()
            t = time.perf_counter()
            leg.fn()
            sync()
            rates.append(leg.nbytes / (time.perf_counter() - t) / 1e6)
        med = statistics.median(rates)
        line[leg.key] = med
        line[f"{leg.key}_spread"] = [min(rates), max(rates)]
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        line[f"{leg.key}_peak_gib"] = peak
        report(f"  {leg.key}: {med:.2f} MB/s (median of {args.reps}, "
               f"{min(rates):.2f}-{max(rates):.2f}), peak "
               f"{'not measured' if peak is None else f'{peak:.3f} GiB'} "
               f"[{card}]")
    if compute is not None:
        r = timings(compute, args.reps)
        line["decode_commit_compute_ms_mb"] = r["decode_commit_ms_per_mb"]
        line["encode_commit_compute_ms_mb"] = r["encode_commit_ms_per_mb"]
        line["compute_dispatch_ms"] = r["dispatch_ms"]
        report(f"  compute: {json.dumps(r)}")
    if args.profile:
        line["idle_share"] = {leg.key: idle_share(report, leg.key, leg.fn,
                                                  card, warm=False)
                              for leg in legs}

    value, decode = line.pop("value"), line["decode_mb_s"]
    head_keys = {
        "metric": (f"tamp_tpu_torch container encode throughput (w={w}, "
                   f"extended, {args.corpus} corpus, {kind})" if cuda else
                   "tamp_tpu_torch container encode, CPU rehearsal (plain "
                   "versions, not a device number)"),
        "value": value, "unit": "MB/s",
        "vs_baseline": value / BASELINE_ENCODE_MBS,
        "pipeline": "native (device-greedy: B5, B7, the host greedy "
                    "committer)",
        "corpus_mb": args.mb, "ratio": line.pop("ratio"),
        "decode_mb_s": decode,
        "decode_vs_baseline": decode / BASELINE_DECODE_MBS,
        "optimal_ratio": line.pop("optimal_ratio"),
        "optimal_mb_s": line.pop("optimal_mb_s"),
    }
    return {**head_keys, **line,
            "corpus": args.corpus, "seed": args.seed, "window": w,
            "literal": LITERAL, "shard_size": shard, "workers": workers,
            "reps": args.reps, "setup_s": setup_s, "checks_s": checks_s,
            "run_s": time.perf_counter() - t_run,
            "launches": {leg.key: leg.launches for leg in legs},
            "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                       "count": torch.cuda.device_count() if cuda else 1,
                       "smi": card if cuda else None}}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); --device cpu rehearses on the plain versions",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    print(json.dumps(run(args, lambda s: print(s, flush=True))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

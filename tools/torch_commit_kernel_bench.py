#!/usr/bin/env python3
"""Compute-only times of the port's commit walks on the card: the decode
commit (kernel B4 behind the per-bit parse and the fuse) and the v1 encode
commit (kernel B3 behind the v1 field planner).

    python3 tools/torch_commit_kernel_bench.py [MB] [REPS] [--scale]
        [--device cpu]

The counterpart of tools/commit_kernel_bench.py; bench_torch.py's
``compute`` stage imports :func:`prepare` and :func:`timings` (together
:func:`measure`).  Prints one JSON line of ms per MiB of input:

- decode: one extended stream of MB MiB of bench_torch.build_corpus (the
  card's greedy one-shot, ``tamp_tpu_torch.compress``) through
  ``ops/decode_wavefront.decode_group(mode="commit")``: the payload to the
  card, the per-bit parse, the fuse and B4;
- encode: one v1 stream's packed fields (``len << 23 | idx << 8 | byte``,
  the host exact tables at cap 16, ``engine/greedy.host_v1_tables``)
  already on the card, through ``ops/encode_commit.plan_fields_v1`` and B3.

Each is checked before it is timed (the decode: error word 0 and the whole
input back; the encode: error word 0 and the walk reaching npos - 15),
then timed with CUDA events around LAUNCHES back-to-back calls, REPS times
after a warm-up (the median call is kept).  ``dispatch_ms`` is an empty
launch plus a synchronize (host clock, median); each time is given raw and
less it.  ``--scale``: the same bytes as 1 stream and as 8 streams in one
decode call.  ``--device cpu`` times the plain versions on the host clock,
a rehearsal only: its numbers are not the card's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WINDOW, LITERAL = 10, 8
LAUNCHES = 10  # calls between two CUDA events


def prepare(mb: float, *, scale: bool = False, window: int = WINDOW,
            device=None) -> dict:
    """Build the inputs of :func:`timings` on ``device`` (None: the card),
    run each call once and check it; returns ``{"n": bytes, "device":
    torch.device, "calls": {name: fn}}`` with the calls ``decode_commit``,
    ``encode_commit`` and, with ``scale``, ``scale_s1`` and ``scale_s8``.
    Raises RuntimeError where a check fails."""
    import numpy as np
    import torch

    import tamp_tpu_torch as tt
    from bench_torch import build_corpus
    from tamp_tpu_torch.device import resolve_device
    from tamp_tpu_torch.dictionary import dictionary_array
    from tamp_tpu_torch.engine.encode import model_history
    from tamp_tpu_torch.engine.greedy import host_v1_tables
    from tamp_tpu_torch.ops.decode_wavefront import decode_group
    from tamp_tpu_torch.ops.encode_commit import (
        S_ERR, S_T, TILE, commit_fields, plan_fields_v1,
    )

    dev = resolve_device(device)
    n = max(1, int(mb * (1 << 20)))
    data = build_corpus(n)
    dict_init = dictionary_array(1 << window, literal=LITERAL)

    def dec_call(payloads, size):
        return lambda: decode_group(
            payloads, window=window, literal=LITERAL, extended=True,
            more=False, dict_init=dict_init, dict_reset=dict_init,
            max_out=size, device=dev, mode="commit")

    def check_dec(fn, pieces, what):
        outs, lens, errs = fn()
        errs, lens = errs.cpu().numpy(), lens.cpu().numpy()
        for k, piece in enumerate(pieces):
            if errs[k] != 0 or lens[k] != len(piece) or \
                    outs[k, : len(piece)].cpu().numpy().tobytes() != piece:
                raise RuntimeError(
                    f"{what}: stream {k} decoded with error {errs[k]} to "
                    f"{lens[k]} of {len(piece)} bytes or other bytes")

    stream = tt.compress(data, window=window, literal=LITERAL, device=dev)
    calls = {"decode_commit": dec_call([stream[1:]], n)}
    check_dec(calls["decode_commit"], [data], "decode commit")

    arr = np.frombuffer(data, np.uint8)
    dict_arr, _ = model_history(arr, window, LITERAL, False, None)
    flen, fidx = host_v1_tables(arr, window=window, literal=LITERAL, cap=16,
                                dictionary=dict_arr)
    NP = 1 << (max(n, TILE) - 1).bit_length()
    packed = np.zeros((1, NP), np.int32)
    packed[0, :n] = ((flen.astype(np.int32) << 23)
                     | (fidx.astype(np.int32) << 8) | arr.astype(np.int32))
    packed = torch.from_numpy(packed).to(dev)
    npos = torch.tensor([n], dtype=torch.int32, device=dev)

    def enc():
        A, B = plan_fields_v1(packed, window=window, literal=LITERAL)
        return commit_fields(A, B, npos, max_out=NP + NP // 8 + 64)

    _out, state = enc()
    state = state.cpu().numpy()
    if state[0, S_ERR] != 0 or state[0, S_T] < n - 15:
        raise RuntimeError(f"encode commit: error {state[0, S_ERR]}, walk "
                           f"stopped at {state[0, S_T]} of {n}")
    calls["encode_commit"] = enc

    if scale:
        sub = n // 8
        pieces = [data[s * sub : (s + 1) * sub] for s in range(8)]
        payloads = [tt.compress(p, window=window, literal=LITERAL,
                                device=dev)[1:] for p in pieces]
        calls["scale_s8"] = dec_call(payloads, sub)
        calls["scale_s1"] = dec_call(payloads[:1], sub)
        check_dec(calls["scale_s8"], pieces, "scale, 8 streams")
        check_dec(calls["scale_s1"], pieces[:1], "scale, 1 stream")
    return {"n": n, "device": dev, "calls": calls}


def dispatch_ms(dev, reps: int) -> float:
    """Median ms of an empty launch plus a synchronize (host clock)."""
    import torch

    x = torch.zeros(8, device=dev)
    times = []
    for _ in range(max(3, 3 * reps)):
        t = time.perf_counter()
        x.add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def call_ms(fn, dev, reps: int) -> float:
    """Median ms of one call of ``fn``: CUDA events around LAUNCHES calls,
    ``reps`` times, on the card; the host clock around one call on the
    CPU."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        if dev.type != "cuda":
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(LAUNCHES):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / LAUNCHES)
    return statistics.median(times)


def timings(prepared: dict, reps: int = 3, verbose: bool = False) -> dict:
    """Time the calls of :func:`prepare`: ms per MiB raw and less
    ``dispatch_ms``, and MB/s (1e6 bytes) less it."""
    dev, n = prepared["device"], prepared["n"]
    mib = n / (1 << 20)
    import torch

    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "mb": mib}
    disp = dispatch_ms(dev, reps)
    out["dispatch_ms"] = disp
    for name in ("decode_commit", "encode_commit"):
        ms = call_ms(prepared["calls"][name], dev, reps)
        out[f"{name}_raw_ms_per_mb"] = ms / mib
        net = max(ms - disp, 1e-6)
        out[f"{name}_ms_per_mb"] = net / mib
        out[f"{name}_mb_s"] = n / net / 1e3
    if "scale_s8" in prepared["calls"]:
        t1 = call_ms(prepared["calls"]["scale_s1"], dev, reps)
        t8 = call_ms(prepared["calls"]["scale_s8"], dev, reps)
        out["scale_s1_ms"] = t1
        out["scale_s8_ms"] = t8
        out["scale_s8_vs_s1_aggregate"] = 8 * t1 / t8
    if verbose:
        print(json.dumps(out), flush=True)
    return out


def measure(mb: float, reps: int = 3, scale: bool = False,
            verbose: bool = False, *, window: int = WINDOW,
            device=None) -> dict:
    """:func:`prepare`, then :func:`timings`: the decode and encode commits'
    ms per MiB (keys ``decode_commit_ms_per_mb``,
    ``encode_commit_ms_per_mb``, their ``_raw_`` forms and ``_mb_s``),
    ``dispatch_ms``, and with ``scale`` the 1- and 8-stream decode ms."""
    return timings(prepare(mb, scale=scale, window=window, device=device),
                   reps, verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mb", nargs="?", type=float, default=1.0)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    measure(args.mb, args.reps, args.scale, verbose=True, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

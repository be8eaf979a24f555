#!/usr/bin/env python3
"""Sweep of the port's encode routes across windows and corpora: encode
MB/s, decode MB/s and ratio a row.

    python3 tools/torch_benchmark.py [FILE ...] [--mb 16] [--device cpu]

The counterpart of tools/benchmark.py.  With no files, the two seeded
corpora of bench_torch.build_corpus (``text`` and ``match``, ``--mb`` MiB
each).  For each window 8, 10, 12 and 15 (literal 8, extended):

- ``native``: the host C++ stream (``stream.NativeCompressor``, one write)
  and its decoder (``stream.NativeDecompressor``);
- ``card``: ``tamp_tpu_torch.compress`` and ``decompress``, the input as
  one stream (B5, B7 and the host greedy committer; X2 on one CTA);
- at window 10, ``container``: ``compress_sharded`` with its defaults and
  ``decompress_sharded`` (X2 a batch).

Each round trip is checked (a difference raises); each rate is one call
after a warm-up, a host clock around a call ending in a synchronize.
``--device cpu`` runs the card's routes on the kernels' plain versions,
a rehearsal at tiny sizes: its rates are not the card's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WINDOWS = (8, 10, 12, 15)


def timed(dev, fn):
    """(result, seconds) of one call of ``fn`` ending in a synchronize."""
    import torch

    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--mb", type=float, default=16.0,
                    help="size of each seeded corpus in MiB (default 16)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import tamp_tpu_torch as tt
    from bench_torch import build_corpus, smi
    from tamp_tpu_torch.cli.main import (
        get_compress_implementation, get_decompress_implementation,
    )
    from tamp_tpu_torch.device import resolve_device
    from tamp_tpu_torch.parallel.shard import (
        compress_sharded, decompress_sharded,
    )

    dev = resolve_device(args.device)
    print(smi() if dev.type == "cuda" else "cpu (plain versions, a "
          "rehearsal: not the card's rates)", flush=True)
    if args.files:
        corpora = [(os.path.basename(f), Path(f).read_bytes())
                   for f in args.files]
    else:
        n = int(args.mb * (1 << 20))
        corpora = [(f"{kind}-{args.mb:g}MiB", build_corpus(n, kind=kind))
                   for kind in ("text", "match")]
    native_enc = get_compress_implementation("native")
    native_dec = get_decompress_implementation("native")

    def card_enc(data, window):
        return tt.compress(data, window=window, device=dev)

    def card_dec(blob):
        return tt.decompress(blob, device=dev)

    def container_enc(data, window):
        return compress_sharded(data, window=window, device=dev)

    def container_dec(blob):
        return decompress_sharded(blob, device=dev)

    routes = (("native", lambda d, w: native_enc(d, window=w), native_dec),
              ("card", card_enc, card_dec))
    print(f"{'corpus':<16} {'route':<10} {'w':>2} {'enc MB/s':>9} "
          f"{'dec MB/s':>9} {'ratio':>6}", flush=True)
    for name, data in corpora:
        for w in WINDOWS:
            rows = routes + ((("container", container_enc, container_dec),)
                             if w == 10 else ())
            for route, enc, dec in rows:
                enc(data[:4096], w)  # warm: builds, first calls
                blob, dt = timed(dev, lambda: enc(data, w))
                dec(blob)
                out, ddt = timed(dev, lambda: dec(blob))
                if bytes(out) != data:
                    raise RuntimeError(f"{name}, {route}, w{w}: the round "
                                       "trip differs")
                print(f"{name:<16} {route:<10} {w:>2} "
                      f"{len(data) / dt / 1e6:>9.2f} "
                      f"{len(data) / ddt / 1e6:>9.2f} "
                      f"{len(blob) / max(1, len(data)):>6.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

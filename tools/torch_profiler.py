#!/usr/bin/env python3
"""cProfile of one compress call of the port (host time by function).

    python3 tools/torch_profiler.py [--engine device-commit] [--mb 4]
        [--device cpu]

The counterpart of tools/profiler.py.  ``--engine``: ``native``,
``tables``, ``device-commit`` (the default: the main path, whose host prep
and tails run in the host C++, engine/greedy.host_ext_prep and
host_ext_tail_bits; tools/torch_host_prep_probe.py times them apart) or
``optimal``, each
``compress_sharded`` of that engine name on the card; or ``python``, the
port's Python codec (``compressor.compress``, host only, ~0.5 MB/s).  The
input is ``--mb`` MiB of bench_torch.build_corpus in 1 MiB shards.  One
call warms up (kernel builds, first calls); the next runs under cProfile,
and the top 25 functions by cumulative time are printed.  cProfile charges
every Python call and not the work inside native code or on the card, so
its shares point at candidates; measure them with bench_torch.py.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ENGINES = ("native", "python", "tables", "device-commit", "optimal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=ENGINES, default="device-commit")
    ap.add_argument("--mb", type=float, default=4.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench_torch import build_corpus, smi

    data = build_corpus(int(args.mb * (1 << 20)))
    if args.engine == "python":
        from tamp_tpu_torch.compressor import compress

        def fn():
            return compress(data)
    else:
        from tamp_tpu_torch.device import resolve_device
        from tamp_tpu_torch.parallel.shard import compress_sharded

        dev = resolve_device(args.device)
        print(smi() if dev.type == "cuda" else "cpu (plain versions)",
              flush=True)

        def fn():
            out = compress_sharded(data, engine=args.engine, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return out

    fn()  # warm
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host rates of the port's C++ stream (``tamp_tpu_torch.stream``) beside
the table-less greedy committer it runs, on chip_smoke.py's 8 MiB corpus.

    python3 tools/torch_stream_probe.py [--reps 3]

Prints, for each, the median MB/s of ``--reps`` runs and every run's:
the one-shot table-less committer (``engine/greedy.greedy_compress``),
``NativeCompressor`` fed the corpus in writes of 4096 bytes, 64 KiB,
1 MiB and one write, then 1 MiB in 1-byte and 7-byte writes (the cost of
a call), and ``NativeDecompressor`` reading it back in 64 KiB reads;
every stream is checked equal to the one-shot's.  Host code only: it
needs no card, and the card's name is printed for the record.
"""

from __future__ import annotations

import argparse
import io
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tamp_tpu_torch.engine.greedy import greedy_compress  # noqa: E402
from tamp_tpu_torch.stream import (  # noqa: E402
    NativeCompressor, NativeDecompressor,
)

CHUNKS = (4096, 1 << 16, 1 << 20, None)  # None: the whole input at once
SMALL_CHUNKS = (1, 7)
SMALL_BYTES = 1 << 20


def stream(data: bytes, chunk: int | None) -> bytes:
    buf = io.BytesIO()
    with NativeCompressor(buf) as c:
        step = chunk or max(1, len(data))
        for i in range(0, len(data), step):
            c.write(data[i : i + step])
    return buf.getvalue()


def rate(name: str, n: int, fn, reps: int, want: bytes | None):
    runs = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        runs.append(n / (time.perf_counter() - t) / 1e6)
        if want is not None and out != want:
            raise SystemExit(f"{name}: the output differs")
    print(f"{name}: {statistics.median(runs):.2f} MB/s (runs "
          f"{', '.join(f'{r:.2f}' for r in runs)})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args().reps
    try:
        print(f"card: {chip_smoke.smi()}", flush=True)
    except FileNotFoundError:
        print("card: none (no nvidia-smi): not a card host's rates",
              flush=True)
    data = chip_smoke.corpus(8 << 20)
    want = greedy_compress(data)
    rate("table-less committer, one-shot", len(data),
         lambda: greedy_compress(data), reps, want)
    for chunk in CHUNKS:
        rate(f"C++ stream, writes of {chunk or len(data)} bytes", len(data),
             lambda: stream(data, chunk), reps, want)
    small = data[:SMALL_BYTES]
    small_want = greedy_compress(small)
    for chunk in SMALL_CHUNKS:
        rate(f"C++ stream of {len(small)} bytes, writes of {chunk} bytes",
             len(small), lambda: stream(small, chunk), reps, small_want)

    def read():
        d = NativeDecompressor(want)
        out = bytearray()
        while piece := d.read(1 << 16):
            out += piece
        return bytes(out)

    rate("C++ stream decode, reads of 65536 bytes", len(data), read, reps,
         data)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the optional trace,
the reference's check, and the result line.

Set-up (``setup_s``, from process start to the first timed call): import,
the port's native libraries built or loaded from ``build/tamp_tpu_torch/``
inside the checkout (``ops/_build.py``, keyed by source hash), the pool of
distinct inputs made from ``--seed`` on the card (the configuration's
corpus), then
the entry point's own set-up (a decode cell's containers) and its warm calls.

The window is a closed loop: one caller makes the entry point's call back to
back, cycling the pool, and closes it at the end of the call that crosses
``--seconds``.  Each call is timed on the host clock and ends in
``torch.cuda.synchronize()``.  The results of the pool's first pass and a
seeded reservoir of ``keep`` later calls are kept for the check.

With ``--trace 1`` the entry point then makes ``trace_calls`` more calls under
``torch.profiler``; the per-layer metrics read the window's host times and
the trace, and the line carries ``busy_s``, ``window_s`` and ``breakdown``.

After the window: the peak device memory, the entry point's check against
the plain reference (``portbench/reference/``), each number beside its limit,
and the metric readers; last, the check that no module of JAX or of the JAX
package is loaded, which refuses the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field

from .spec import Cell, load_cell, load_module

__all__ = ["Run", "main", "parse_args", "forbidden_modules", "FORBIDDEN"]

# top-level module names a run may not hold (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tamp_tpu")


@dataclass
class Call:
    start: float
    end: float
    raw_bytes: int  # uncompressed bytes the call handled
    packed_bytes: int  # container bytes the call wrote or read
    ok: bool


@dataclass
class Run:
    """Everything one run knows; entry points and metric readers take it."""

    cell: Cell
    seed: int
    device: str  # "cuda", or "cpu" for a rehearsal with the plain versions
    shard_bytes: int
    inputs: list = field(default_factory=list)
    state: dict = field(default_factory=dict)  # the entry point's own
    calls: list = field(default_factory=list)  # the window's Call records
    kept: dict = field(default_factory=dict)  # call index -> its result
    trace: object = None  # harness.trace.Trace with --trace 1
    entry: object = None  # the cell's portbench/entries/<op>.py
    window_s: float = 0.0
    setup_s: float = 0.0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def shards(self) -> int:
        return int(self.traffic["shards"])

    @property
    def prog_device(self):
        """The program's ``device`` argument: None (the card) or "cpu"."""
        return None if self.device == "cuda" else "cpu"

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal on the kernels' plain versions; "
                         "its numbers are no device metrics")
    ap.add_argument("--shard-bytes", type=int, default=None,
                    help="rehearsal only: every shard cut to this size")
    ap.add_argument("--shards", type=int, default=None,
                    help="rehearsal only: this many shards a call")
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    if args.device == "cuda" and (args.shard_bytes or args.shards):
        ap.error("--shard-bytes and --shards cut a rehearsal only "
                 "(--device cpu)")
    if args.device == "cpu" and args.trace:
        ap.error("--trace 1 reads the card's trace")
    return args


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _card() -> dict:
    """The card's name, count and power limit, and the host's CPU count."""
    import torch

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    smi = (r.stdout.strip().splitlines() or ["?"])[0] if r.returncode == 0 \
        else f"nvidia-smi failed ({r.returncode})"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "smi": smi, "cpus": os.cpu_count()}


def _window(run: Run, call, seconds: float) -> None:
    """The closed loop: calls back to back until one ends past
    ``seconds``; the first pass of the pool and a seeded reservoir of
    ``keep`` later results are kept."""
    pool = len(run.inputs)
    keep = int(run.traffic.get("keep", 2))
    pick = random.Random(run.seed ^ 0x5EED)
    later = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        try:
            result = call(i)
            run.sync()
            ok = True
        except Exception as e:  # a failed call counts; the run goes on
            print(f"portbench: call {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            result, ok = None, False
        end = time.perf_counter()
        raw, packed = run.entry.account(run, i, result) if ok else (0, 0)
        run.calls.append(Call(start, end, raw, packed, ok))
        if ok and i < pool:
            run.kept[i] = result
        elif ok:
            later += 1
            if later <= keep:
                run.kept[i] = result
            else:
                j = pick.randrange(later)
                if j < keep:
                    old = sorted(k for k in run.kept if k >= pool)[j]
                    del run.kept[old]
                    run.kept[i] = result
        i += 1
        if end - t0 >= seconds:
            break
    run.window_s = run.calls[-1].end - run.calls[0].start


def _read(run: Run, entries) -> dict:
    """Each metric entry's reader (``portbench/metrics/<name>.py``) on the
    run: ``{name: {"value", "unit"}}``, a reader returning None left out."""
    out = {}
    for m in entries:
        mod = load_module(run.cell.dir / "metrics" / f"{m['name']}.py",
                          f"portbench_metric_{m['name'].replace('.', '_')}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(args, t0: float, replace=None) -> dict:
    """The run without printing; ``replace(run)`` returns the call that
    takes the program's place (a control or a planted fault)."""
    cell = load_cell(args.workload)
    shard_bytes = args.shard_bytes or int(cell.traffic["shard_bytes"])
    if args.shards:
        cell.traffic["shards"] = args.shards
    run = Run(cell=cell, seed=args.seed, device=args.device,
              shard_bytes=shard_bytes)
    run.entry = load_module(cell.dir / "entries" / f"{cell.traffic['op']}.py",
                             f"portbench_entry_{cell.traffic['op']}")
    phases = []

    def phase(name):
        phases.append((name, time.perf_counter()))

    phase("start")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("portbench: no CUDA device "
                             "(torch.cuda.is_available() is False)")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"portbench: the cell needs {cell.chips} "
                             f"cards, {torch.cuda.device_count()} seen")
        torch.zeros(1, device="cuda")
        phase("torch and the card")
        from tamp_tpu_torch.ops import _build

        _build.build_all()
        phase("kernels built or found")
    corpus = load_module(cell.dir / "corpora" / f"{cell.config['data']}.py",
                         "portbench_corpus")
    run.inputs = corpus.make_inputs(
        cell.config["assumed"]["corpus"], args.seed,
        int(cell.traffic["pool"]), run.shards, shard_bytes, args.device)
    phase("inputs")
    run.entry.setup(run)
    phase("entry set-up")
    call = (lambda i: run.entry.call(run, i)) if replace is None \
        else replace(run)
    warm_failed = 0
    for i in range(int(cell.traffic.get("warm_calls", 2))):
        try:
            call(i)
            run.sync()
        except Exception as e:  # counted below, as a window's failure is
            print(f"portbench: warm call {i} failed: {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            warm_failed += 1
    if args.device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    phase("warm calls")
    run.setup_s = time.perf_counter() - t0
    print("portbench: set-up " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(phases, phases[1:]))
        + f"; {phases[0][1] - t0:.3f} s before, {run.setup_s:.3f} s in all",
        file=sys.stderr)
    _window(run, call, args.seconds)
    device = {"platform": "cpu", "kind": "cpu", "count": 0,
              "memory_peak_bytes": 0}
    if args.device == "cuda":
        import torch

        device = {**_card(), "count": cell.chips,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    breakdown = None
    if args.trace:
        from .trace import profile

        run.trace = profile(call, len(run.calls),
                            int(cell.traffic["trace_calls"]))
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        breakdown = run.trace.breakdown()
    failed = sum(not c.ok for c in run.calls)
    checks = {"calls_failed": (failed + warm_failed, 0),
              **run.entry.check(run, run.kept)}
    metrics = _read(run, cell.per_layer if args.trace else cell.end_to_end)
    correct = all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": len(run.calls),
            "failed": failed, "metrics": metrics, "device": device}
    if args.device == "cpu":  # a rehearsal: no number under a metric's name
        line["rehearsal"] = {k: v["value"] for k, v in metrics.items()}
        line["metrics"] = {k: {"value": None, "unit": v["unit"]}
                           for k, v in metrics.items()}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    # last, once every metric reader and the check have been loaded and run
    bad = forbidden_modules()
    if bad:
        raise SystemExit("portbench: modules of JAX or of the JAX package "
                         f"are loaded: {', '.join(bad)}")
    return line


def main(argv, t0: float) -> int:
    """``run.py``'s entry: one run, its checks on standard error, then the
    result line; ``t0`` is the process's start on ``time.perf_counter``."""
    args = parse_args(argv)
    print(f"portbench: {args.workload} seed {args.seed}, {os.cpu_count()} "
          f"CPUs, device {args.device}", file=sys.stderr)
    line = execute(args, t0)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0

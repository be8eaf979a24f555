"""The port's compile-check and multi-device dry-run entry points: the
JAX package's ``__graft_entry__.py`` on the card.

- :func:`entry` returns ``(fn, args)``: the flagship compute, the match
  tables of one 256-position chunk at window 10 (the JAX ``mxu_chunk``),
  as two launches of kernel B5.
- :func:`dryrun_multichip` runs one data-parallel search step, the five
  encode legs of :func:`dryrun_encodes` and one decode step over a world
  of ``n_devices`` processes, one GPU each, each leg held to a reference
  of the port's own.

    python -m tamp_tpu_torch.entry    # fn once, then the dry run on every
                                      # GPU (DRYRUN_DEVICES to choose)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["entry", "dryrun_multichip", "dryrun_encodes",
           "planned_reference", "run_heavy_mix"]

ENTRY_WINDOW = 10   # entry(): window bits of the chunk's tables
ENTRY_T = 256       # entry(): positions of the chunk (twice as many bytes)
SHARD_LEN = 8192    # dry run: bytes a row (ring wraps, runs, a real mix)
RANK_TIMEOUT_S = 600  # dry run: how long spawned ranks may run in all


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` returns the JAX ``mxu_chunk``'s six
    tables, ``(len15, idx15, len16, idx16, plen, pidx)``, each (256,)
    int32, for positions [0, 256) of 512 seeded bytes (a-z) after the w10
    v1 dictionary.  ``args``: the (1, NP) uint8 row, its (1,) int32 length
    and the (1024,) uint8 dictionary, on the card unless ``device="cpu"``.
    ``fn`` launches kernel B5 twice: cap 15 with the probe (``len15``,
    ``idx15`` and the probe ``plen``, ``pidx``: the target one byte on,
    the ring as at the position, cap 15, as ``mxu_chunk`` scores it) and
    cap 16 (``len16``, ``idx16``).  It holds no state between calls."""
    import torch

    from .device import resolve_device
    from .dictionary import dictionary_array
    from .engine.pipeline import pad_shards
    from .ops.match_v1 import v1_tables

    dev = resolve_device(device)
    data = np.random.default_rng(0).integers(97, 123, 2 * ENTRY_T,
                                             dtype=np.uint8)
    rows, npos = pad_shards([data])
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        rows, npos, dictionary_array(1 << ENTRY_WINDOW, literal=8)))

    def fn(rows, npos, dict_arr):
        len15, idx15, plen, pidx = v1_tables(
            rows, npos, dict_arr, window_bits=ENTRY_WINDOW, cap=15,
            probe=True)
        len16, idx16 = v1_tables(rows, npos, dict_arr,
                                 window_bits=ENTRY_WINDOW, cap=16)
        return tuple(t[0, :ENTRY_T]
                     for t in (len15, idx15, len16, idx16, plen, pidx))

    return fn, args


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def planned_reference(raw: bytes, window: int, literal: int) -> bytes:
    """The native planned committer's stream of ``raw`` (the JAX entry's
    ``native_planned``) from the port's host parts: the run plan and model
    history (``engine/plan.ext_prep``), the exact cap-16 tables of the
    model stream gathered at the input positions, the table committer
    forced into planned mode, with divergence avoidance."""
    from .engine.greedy import host_v1_tables, table_compress
    from .engine.plan import ext_prep

    plans, khat, dh, _rc = ext_prep(np.frombuffer(raw, np.uint8), window)
    l16, i16 = host_v1_tables(dh, window=window, literal=literal, cap=16)
    rows = np.minimum(khat[:-1].astype(np.int64), max(0, dh.shape[0] - 1))
    return table_compress(raw, window=window, literal=literal,
                          tables=(l16[rows], i16[rows]), khat=khat,
                          plan=plans, avoid_divergence=True,
                          force_planned=True)


def run_heavy_mix(data: np.ndarray) -> list[bytes]:
    """The dry run's extended rows: each row of ``data`` with a planned run
    of 300 bytes at 200 and bytes 100-200 repeated at 4000."""
    mix = []
    for i in range(data.shape[0]):
        row = bytearray(data[i].tobytes())
        row[200:500] = bytes([65 + i]) * 300
        row[4000:4100] = row[100:200]
        mix.append(bytes(row))
    return mix


def _round_trip(name: str, streams, raws, device) -> None:
    """The container of ``streams`` decodes to ``raws`` by both device
    algorithms (the wavefront in its default mode, and X2)."""
    from .parallel.shard import _pack_frame, decompress_sharded_device

    blob = _pack_frame(streams, sum(len(r) for r in raws), len(raws[0]))
    for algorithm in ("wavefront", "serial"):
        back = decompress_sharded_device(blob, algorithm=algorithm,
                                         device=device)
        _check(bytes(back) == b"".join(raws),
               f"{name}: the {algorithm} decode differs from the input")


def dryrun_encodes(shards, mix, *, device=None) -> dict:
    """The dry run's five encode legs on the card (``device="cpu"``: the
    plain versions), each checked by the port alone; returns each leg's
    streams by name.

    - ``"v1"``: ``encode_v1_device_commit`` of ``shards`` at w8 l8; the
      streams round-trip by both device decoders.
    - ``"extended"``: ``encode_ext_device_commit`` of ``mix`` at w10 l8,
      each stream equal to :func:`planned_reference`; round trip.
    - ``"greedy"``: ``encode_ext_device_greedy(pull="sparse")`` of
      ``mix[:2]``, each equal to the table-less ``greedy_compress``.
    - ``"v1 optimal"``, ``"extended optimal"``: the ``device-optimal``
      encodes of ``mix[:2]``: round trip, and no stream larger than the
      greedy one of its format (``encode_v1_device_commit``, ``"greedy"``)
      on the same shard."""
    from .engine.greedy import greedy_compress
    from .engine.pipeline import (
        encode_v1_device_commit, encode_v1_device_optimal,
    )
    from .engine.pipeline_ext import (
        encode_ext_device_commit, encode_ext_device_greedy,
        encode_ext_device_optimal,
    )

    kw = dict(window=10, literal=8, device=device)
    out = {"v1": encode_v1_device_commit(shards, window=8, literal=8,
                                         device=device)}
    _round_trip("v1", out["v1"], shards, device)
    out["extended"] = encode_ext_device_commit(mix, **kw)
    for i, b in enumerate(out["extended"]):
        _check(b == planned_reference(mix[i], 10, 8),
               f"device extended encode diverged on shard {i}")
    _round_trip("extended", out["extended"], mix, device)
    out["greedy"] = encode_ext_device_greedy(mix[:2], pull="sparse", **kw)
    for i, b in enumerate(out["greedy"]):
        _check(b == greedy_compress(mix[i], window=10, literal=8),
               f"greedy device encode diverged on shard {i}")
    out["v1 optimal"] = encode_v1_device_optimal(mix[:2], **kw)
    out["extended optimal"] = encode_ext_device_optimal(mix[:2], **kw)
    v1_greedy = encode_v1_device_commit(mix[:2], **kw)
    for name, greedy in (("v1 optimal", v1_greedy),
                         ("extended optimal", out["greedy"])):
        _round_trip(name, out[name], mix[:2], device)
        for i, (b, g) in enumerate(zip(out[name], greedy)):
            _check(len(b) <= len(g), f"{name}: shard {i} takes {len(b)} "
                   f"bytes, the greedy parse {len(g)}")
    return out


def _dryrun_rank(n_devices: int, device) -> None:
    """One rank of the dry run in the current world (a world of one made
    by ``make_mesh`` when none is up): the search step, the decode step,
    then on rank 0 the encode legs and the summary line."""
    import torch.distributed as dist

    from .engine.greedy import greedy_compress
    from .parallel.shard import (
        make_mesh, sharded_decode_step, sharded_search_step,
    )

    mesh = make_mesh(n_devices, device=device)
    data = np.random.default_rng(1).integers(97, 123, (n_devices, SHARD_LEN),
                                             dtype=np.uint8)
    out = sharded_search_step(mesh, data, window_bits=8, literal_bits=8)
    _check(tuple(out["len16"].shape) == (n_devices, SHARD_LEN),
           f"search step tables of shape {tuple(out['len16'].shape)}")
    est = float(out["est_bits_total"])
    _check(est > 0, f"search step estimate {est}")
    shards = [bytes(r) for r in data]
    streams = [greedy_compress(s, window=8, literal=8) for s in shards]
    outs, dlens, total = sharded_decode_step(mesh, streams,
                                             max_out=SHARD_LEN)
    dlens = dlens.cpu().numpy()
    _check(int(total) == n_devices * SHARD_LEN,
           f"decode step total {int(total)}")
    outs = outs.cpu().numpy()
    for i, s in enumerate(shards):
        _check(outs[i, : dlens[i]].tobytes() == s,
               f"decode step differs on shard {i}")
    # the encodes come last: a rank that raised before a collective would
    # leave the others waiting in it
    if dist.get_rank() == 0:
        dryrun_encodes(shards, run_heavy_mix(data), device=device)
        print(f"dryrun_multichip ok: {n_devices} devices, "
              f"est_bits_total={est:.0f}, device-encode parity on "
              f"{n_devices} shards (v1 + extended + greedy-sparse + "
              f"v1-optimal + ext-optimal, {SHARD_LEN}B each), "
              f"decoded={int(dlens.sum())}B", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(n_devices: int, device: str) -> None:
    """Run the dry run in ``n_devices`` child processes joined over
    loopback (``python -m tamp_tpu_torch.entry --rank ...``), killing all
    when one fails or RANK_TIMEOUT_S pass; RuntimeError unless each
    exits 0."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tamp_tpu_torch.entry", "--rank", str(rank),
         str(n_devices), addr, device], env={**env, "LOCAL_RANK": str(rank)})
        for rank in range(n_devices)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"dryrun_multichip: rank {bad[0]} exited "
                                   f"{codes[bad[0]]}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"dryrun_multichip: the ranks ran past "
                                   f"{RANK_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def dryrun_multichip(n_devices: int, *, device=None) -> None:
    """The JAX package's ``dryrun_multichip`` on the port: over a world of
    ``n_devices`` processes, one GPU each (``device="cpu"``: gloo and the
    plain versions), ``sharded_search_step`` on seeded (n, 8192) bytes at
    w8 l8, ``sharded_decode_step`` of the rows' w8 streams, and on rank 0
    :func:`dryrun_encodes` on the rows and :func:`run_heavy_mix`; prints a
    summary line on rank 0.  Runs in place in a world of ``n_devices``
    that is already up, or that a launcher's environment describes
    (``torchrun``: ``WORLD_SIZE`` above 1 and ``RANK``; the world is
    joined and left here); without one, in this process for ``n_devices
    == 1`` (its world of one destroyed at the end), else in ``n_devices``
    child processes it starts.  On the card ``n_devices`` may not exceed
    the GPUs (ValueError): NCCL takes one rank a GPU.  Raises when a check
    fails; returns None."""
    import torch
    import torch.distributed as dist

    from .device import resolve_device
    from .parallel.distributed import initialize

    dev = resolve_device(device)
    launched = not dist.is_initialized() and int(
        os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:
        initialize(None, int(os.environ["WORLD_SIZE"]),
                   int(os.environ["RANK"]), device=dev)
    if dist.is_initialized():
        try:
            _dryrun_rank(n_devices, dev)
        finally:
            if launched:
                dist.destroy_process_group()
        return
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, not {n_devices}")
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"requested {n_devices} devices, "
                         f"{torch.cuda.device_count()} GPUs are present")
    if n_devices > 1:
        _spawn_ranks(n_devices, dev.type)
        return
    try:
        _dryrun_rank(1, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_main(rank: int, n_devices: int, addr: str, device: str) -> int:
    import torch.distributed as dist

    from .parallel.distributed import initialize

    initialize(addr, n_devices, rank, device=device)
    try:
        _dryrun_rank(n_devices, device)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        return _rank_main(int(argv[1]), int(argv[2]), argv[3], argv[4])
    import torch

    fn, args = entry()
    print(fn(*args)[0][:8])
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES",
                                        torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Multi-process orchestration on ``torch.distributed`` (the JAX package's
``parallel/distributed.py``).

One process a device.  :func:`initialize` joins the processes into one
world, :func:`global_mesh` builds the 1-D mesh over it, and
:func:`compress_distributed` has each process encode the shards it owns
and gathers the variable-length streams in order to process 0, which
frames the TTPU container.  The gather moves host bytes only (gloo), since
the Tamp format leaves framing to the container: no ragged device
collective is needed, and any shard decodes alone.

A two-process world on one host, one GPU each::

    # process i of 2 (i = 0, 1)
    initialize("127.0.0.1:29500", 2, i)
    blob = compress_distributed(data)   # the container on process 0
"""

from __future__ import annotations

import datetime
import os

__all__ = ["initialize", "global_mesh", "compress_distributed"]

# how long a collective or the rendezvous waits for the other processes
TIMEOUT = datetime.timedelta(seconds=60)


def backend(dev) -> str:
    """The process group backend for ``dev``'s world: NCCL for CUDA
    tensors beside gloo for host tensors on the card, gloo on the CPU."""
    return "cuda:nccl,cpu:gloo" if dev.type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` where the launcher
    sets it, else the world rank (one host)."""
    import torch.distributed as dist

    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, device=None):
    """Join this process to the world (no-op when single-process or
    already joined).

    ``coordinator_address`` is ``host:port`` of process 0 (``tcp://``
    rendezvous), ``num_processes`` the world size and ``process_id`` this
    process's rank; with no address, ``torch.distributed``'s ``env://``
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    give them.  ``device``: None for the CUDA card, each process on
    ``cuda:{local rank % device count}``; ``"cpu"`` for a gloo world."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    if dist.is_initialized():
        return
    if num_processes in (None, 1) and coordinator_address is None:
        return
    dev = resolve_device(device)
    dist.init_process_group(
        backend(dev),
        init_method=(None if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=TIMEOUT)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())


def global_mesh(axis: str = "dp", *, device=None):
    """A 1-D mesh over every process of the world, one device each."""
    from .shard import make_mesh

    return make_mesh(axis=axis, device=device)


def compress_distributed(
    data: bytes,
    *,
    window: int = 10,
    literal: int = 8,
    extended: bool = True,
    dictionary: bytes | None = None,
    shard_size: int = 1 << 20,
    workers: int | None = None,
    engine: str = "native",
    device=None,
) -> bytes | None:
    """Compress ``data`` cooperatively across the world's processes.

    Every process passes the same ``data``.  Each encodes the TTPU shards
    it owns (round-robin: shard i belongs to rank ``i % world``) as one
    batch with ``engine``'s encoder, lazy matching off (the engines of
    :func:`tamp_tpu_torch.parallel.shard.compress_sharded`, ``"native"`` by
    default as in the JAX package; an unknown name, or a shard longer than
    MAX_STREAM_BYTES, raises ValueError on every rank before any
    collective).  Two host gathers follow: the shards' sizes, each
    rank filling its own, then one flat buffer a rank, padded to the
    largest rank's total.  Returns the container on rank 0, byte-identical
    to ``compress_sharded``'s, and None elsewhere; a single-process call
    is ``compress_sharded``.  ``device``: None for the card, ``"cpu"`` for
    the plain versions.  A shard that ``literal`` cannot hold raises
    ExcessBitsError on every rank."""
    import torch
    import torch.distributed as dist

    from ..constants import compute_min_pattern_size
    from ..exceptions import ExcessBitsError
    from .shard import _check_shard, _encoder, _pack_frame, compress_sharded

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return compress_sharded(
            data, window=window, literal=literal, extended=extended,
            dictionary=dictionary, shard_size=shard_size, workers=workers,
            engine=engine, device=device)
    # checks that raise alike on every rank, before any collective
    encode = _encoder(engine, extended, workers)
    compute_min_pattern_size(window, literal)
    _check_shard(shard_size, len(data))

    pid, n = dist.get_rank(), dist.get_world_size()
    data = bytes(data)
    shards = [data[i : i + shard_size]
              for i in range(0, len(data), shard_size)] or [b""]
    owned = list(range(pid, len(shards), n))
    blobs, failed = [], 0
    if owned:
        try:
            blobs = encode([shards[i] for i in owned], window=window,
                           literal=literal, lazy_matching=False,
                           dictionary=dictionary, device=device)
        except ExcessBitsError:
            failed = 1
    # round 1: each rank's sizes of the shards it owns, zero elsewhere,
    # and last its failure flag
    sizes = torch.zeros(len(shards) + 1, dtype=torch.int64)
    for i, b in zip(owned, blobs):
        sizes[i] = len(b)
    sizes[-1] = failed
    parts = [torch.empty_like(sizes) for _ in range(n)]
    dist.all_gather(parts, sizes)
    all_sizes = torch.stack(parts)
    if int(all_sizes[:, -1].sum()):
        raise ExcessBitsError("a shard has more bits than literal holds")
    all_sizes = all_sizes[:, :-1]
    # round 2: one flat buffer a rank, its streams in shard order
    flat = b"".join(blobs)
    buf = torch.zeros(max(int(all_sizes.sum(1).max()), 1), dtype=torch.uint8)
    if flat:
        buf[: len(flat)] = torch.frombuffer(bytearray(flat),
                                            dtype=torch.uint8)
    gathered = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(gathered, buf)
    if pid != 0:
        return None
    sizes = all_sizes.amax(0).tolist()  # one owner a shard
    offsets = [0] * n
    out = []
    for i, size in enumerate(sizes):
        owner = i % n
        out.append(gathered[owner][offsets[owner] : offsets[owner] + size]
                   .numpy().tobytes())
        offsets[owner] += size
    return _pack_frame(out, len(data), shard_size)

"""TTPU containers of independent Tamp streams, encoded and decoded on the card.

Container format (``TTPU``, the JAX package's ``parallel/shard.py``): one
Tamp stream per shard, with a small host-side frame recording the shard
boundaries.  Any single shard is a spec-conforming Tamp stream.

    magic   b"TTPU"
    u8      container version (2; v1 still read)
    u8      reserved (0)
    u32le   shard count
    u64le   raw (uncompressed) size
    u64le   shard size (v2 only: raw bytes per shard, last may be short)
    u32le * shard compressed sizes
    bytes   concatenated Tamp streams

Either package reads the containers the other writes.

The mesh layer (the JAX module's ``make_mesh``, ``sharded_search_step``
and ``sharded_decode_step``) runs on ``torch.distributed``: one process a
device, a 1-D ``DeviceMesh`` for the data-parallel axis, ``all_reduce``
where the JAX steps ``psum`` and list-form ``all_gather`` where
``np.asarray`` of their sharded results gathers the blocks.
"""

from __future__ import annotations

import os
import struct

__all__ = ["make_mesh", "sharded_search_step", "sharded_decode_step",
           "compress_sharded", "compress_file_sharded",
           "decompress_sharded_device", "decompress_file_sharded",
           "DEFAULT_SHARD_SIZE"]

MAGIC = b"TTPU"
DEFAULT_SHARD_SIZE = 1 << 20


def _pack_frame(blobs, raw_size: int, shard_size: int) -> bytes:
    """TTPU v2 frame: records shard_size so decoders can place every
    shard's output at ``i * shard_size`` without decoding in order."""
    head = MAGIC + struct.pack("<BBIQQ", 2, 0, len(blobs), raw_size,
                               shard_size)
    sizes = struct.pack(f"<{len(blobs)}I", *(len(b) for b in blobs))
    return head + sizes + b"".join(blobs)


def _read_exact(read, k: int) -> bytes:
    """``k`` bytes from ``read`` (a binary file's ``read``), ValueError on a
    short read: a truncated frame or shard is refused, never decoded."""
    b = read(k)
    if len(b) != k:
        raise ValueError("truncated TTPU container")
    return b


def _read_head(read):
    """(raw_size, shard_size | None, sizes) of the frame whose bytes
    ``read(k)`` returns in order, the shard bytes left unread.  Reads v1
    (no shard_size) and v2 frames."""
    head = read(18)
    if head[:4] != MAGIC:
        raise ValueError("not a TTPU container")
    if len(head) != 18:
        raise ValueError("truncated TTPU container")
    ver, _res, n, raw_size = struct.unpack_from("<BBIQ", head, 4)
    shard_size = None
    if ver == 2:
        (shard_size,) = struct.unpack("<Q", _read_exact(read, 8))
    elif ver != 1:
        raise ValueError(f"unsupported TTPU version {ver}")
    return raw_size, shard_size, struct.unpack(f"<{n}I",
                                               _read_exact(read, 4 * n))


def _parse_frame(blob):
    """-> (raw_size, shard_size | None, pieces).  Reads v1 (no shard_size)
    and v2 frames; a truncated one raises ValueError."""
    at = 0

    def read(k: int):
        nonlocal at
        at += k
        return blob[at - k : at]

    raw_size, shard_size, sizes = _read_head(read)
    return raw_size, shard_size, [_read_exact(read, sz) for sz in sizes]


def _max_out(frame_shard_size, shard_size):
    """The per-shard output bound of a decode: the caller's ``shard_size``,
    else the v2 frame's, else (a v1 frame) DEFAULT_SHARD_SIZE."""
    if shard_size is None:
        shard_size = frame_shard_size
    return DEFAULT_SHARD_SIZE if shard_size is None else shard_size


def _decoder(algorithm: str):
    """The batch decoder of ``algorithm`` (see
    :func:`decompress_sharded_device`): ``decode(pieces, *, max_out,
    dictionary, device) -> list[bytes]``."""
    if algorithm == "wavefront":
        from ..ops.decode_wavefront import decode_shards_wavefront as decode
    elif algorithm == "serial":
        from ..ops.decode_serial import decode_shards_device as decode
    else:
        raise ValueError(f"unknown device decode algorithm: {algorithm!r}")
    return decode


def _encoder(engine: str, extended: bool, workers: int | None):
    """The batch encoder of ``engine`` (see :func:`compress_sharded`):
    ``encode(shards, *, window, literal, lazy_matching, dictionary,
    device) -> list[bytes]``, one Tamp stream a shard.  Raises
    NotImplementedError for the JAX package's host engines."""
    if engine == "device":
        from ..engine.pipeline import encode_device_batch

        def encode(shards, **kw):
            return encode_device_batch(shards, extended=extended,
                                       workers=workers, **kw)
    elif engine == "device-optimal":
        if extended:
            from ..engine.pipeline_ext import (
                encode_ext_device_optimal as optimal,
            )
        else:
            from ..engine.pipeline import encode_v1_device_optimal as optimal

        def encode(shards, *, lazy_matching, **kw):
            return optimal(shards, **kw)
    elif engine == "device-greedy":
        if not extended:
            raise ValueError("device-greedy is the extended-format mode; "
                             "v1 engine='device-commit' is already "
                             "reference-exact")
        from ..engine.pipeline_ext import encode_ext_device_greedy as encode
    elif engine != "device-commit":
        raise NotImplementedError(
            f"engine={engine!r} is not ported: the port has the device "
            "engines 'device-commit', 'device-greedy', 'device-optimal' "
            "and 'device'; the JAX package's host engines stay there")
    elif extended:
        from ..engine.pipeline_ext import encode_ext_device_commit as encode
    else:
        from ..engine.pipeline import encode_v1_device_commit as encode
    return encode


def compress_sharded(
    data: bytes,
    *,
    window: int = 10,
    literal: int = 8,
    extended: bool = True,
    lazy_matching: bool = False,
    dictionary: bytes | None = None,
    shard_size: int = DEFAULT_SHARD_SIZE,
    engine: str = "device-commit",
    device=None,
    workers: int | None = None,
) -> bytes:
    """Compress ``data`` as a TTPU container, all shards batched on the card.

    ``engine="device-commit"``, byte-identical to the JAX package's
    ``compress_sharded(engine="device-commit")``: the extended-format
    planned encode (engine/pipeline_ext.py) or, with ``extended=False``,
    the v1 encode (engine/pipeline.py), each with or without
    ``lazy_matching``.  ``engine="device-greedy"`` (extended only): tables
    on the card, the greedy walk in the host committer; every shard's
    stream is byte-identical to the reference greedy encoder
    (engine/pipeline_ext.encode_ext_device_greedy).
    ``engine="device-optimal"``: the minimum-bit parse with its DP on the
    card, byte-identical to the JAX package's
    ``compress_sharded(engine="device-optimal")``: extended
    (engine/pipeline_ext.encode_ext_device_optimal, streams equal to
    ``encode_extended_optimal``) or v1 (engine/pipeline.
    encode_v1_device_optimal, streams equal to
    ``encode_v1(parse="optimal")``); ``lazy_matching`` does not apply.
    ``engine="device"``, byte-identical to the JAX package's
    ``compress_sharded(engine="device")`` on its Pallas search, with or
    without ``lazy_matching`` (engine/pipeline.encode_device_batch):
    extended, kernel B5's tables of the model histories on the card, one
    launch for all shards, then the host table committer on ``workers``
    threads (default: the CPU count; engine/encode_extended.py, streams
    equal to ``encode_extended``); v1, the ``"device-commit"`` encode,
    whose streams are the same reference greedy ones (``encode_v1``).  The JAX
    package's host engines (``"native"``, ``"tables"``) are not ported
    (NotImplementedError), and nothing falls back to them.
    ``dictionary`` (a full-window custom dictionary) seeds every shard's
    window; pass the same one to the decode side.  ``device``: None for
    the CUDA card, ``"cpu"`` for the plain versions."""
    encode = _encoder(engine, extended, workers)
    data = bytes(data)
    shards = [data[i : i + shard_size]
              for i in range(0, len(data), shard_size)] or [b""]
    blobs = encode(
        shards, window=window, literal=literal, lazy_matching=lazy_matching,
        dictionary=dictionary, device=device)
    return _pack_frame(blobs, len(data), shard_size)


def compress_file_sharded(
    src,
    dst,
    *,
    window: int = 10,
    literal: int = 8,
    extended: bool = True,
    lazy_matching: bool = False,
    dictionary: bytes | None = None,
    shard_size: int = DEFAULT_SHARD_SIZE,
    workers: int | None = None,
    engine: str = "device",
    device=None,
) -> int:
    """Bounded-memory TTPU compression of a file (files larger than RAM),
    the JAX package's ``compress_file_sharded`` with ``engine="device"``
    or, extended only, ``engine="device-greedy"`` (the streams of the JAX
    function's ``engine="native"``: the reference greedy encoder's).

    Reads ``src`` shard by shard, up to ``2 * workers`` shards at a time
    (default ``workers``: the CPU count + 2, as in the JAX package),
    encodes each such batch with one call of ``engine``'s batch encode
    (see :func:`compress_sharded`; ``"device"``: one launch of kernel B5
    and the host committer on ``workers`` threads,
    engine/pipeline.encode_device_batch; ``"device-greedy"``: kernels B5
    and B7 once and the host greedy committer,
    engine/pipeline_ext.encode_ext_device_greedy), and writes the streams
    to ``dst`` in order: the frame header and a zeroed sizes table go out
    first and the sizes are patched in place at the end, so ``dst`` must
    be seekable (a path or a binary file).  The output is byte-identical
    to ``compress_sharded(engine=engine)`` on the whole file.  Returns the
    bytes written.

    Memory, in bytes a byte of one batch (B = 2·workers·shard_size input
    bytes; extended): on the host about 8-14 B held for the batch (the
    input 1, khat 4, the model stream 1, B5's packed planes 2 at window
    <= 10 and 4 above, twice that with the probe, the streams ~1), and
    in each of the ``workers`` threads, for its shard, transients of about
    30 B more (the run plan's int64 indices, the gathered and unpacked
    tables at 5 B a family, the committer's output buffer): ~20-30x B in
    all.  The card holds the batch's rows and B5's int32 planes, 8 B a
    position (16 with lazy matching's probe), until the one pull.  v1
    holds the input, its padded copy and the streams on the host.

    Only ``engine="device"`` and ``"device-greedy"`` stream:
    ``"device-commit"`` (and the other engines, which batch whole
    containers) raise ValueError.  The JAX package's own function writes
    its ``"tables"`` container for any engine name it does not know; the
    port refuses them instead."""
    if engine == "device-commit":
        raise ValueError(
            "device-commit batches whole containers; use compress_sharded, "
            "or engine='device' for the per-shard device search pipeline")
    if engine not in ("device", "device-greedy"):
        raise ValueError(
            f"compress_file_sharded streams engine='device' and "
            f"'device-greedy' only; use compress_sharded for "
            f"engine={engine!r}")
    from ..device import resolve_device

    if workers is None:
        workers = (os.cpu_count() or 4) + 2
    encode = _encoder(engine, extended, workers)
    dev = resolve_device(device)
    close_src = close_dst = False
    if not hasattr(src, "read"):
        src, close_src = open(str(src), "rb"), True
    try:
        if not hasattr(dst, "write"):
            dst, close_dst = open(str(dst), "wb"), True
        pos0 = src.tell()
        raw_size = src.seek(0, 2) - pos0
        src.seek(pos0)
        n_shards = max(1, -(-raw_size // shard_size))
        head_at = dst.tell()
        dst.write(MAGIC + struct.pack(
            "<BBIQQ", 2, 0, n_shards, raw_size, shard_size))
        sizes_at = dst.tell()
        dst.write(b"\x00" * (4 * n_shards))
        sizes = []
        for first in range(0, n_shards, 2 * workers):
            batch = [src.read(shard_size)
                     for _ in range(min(2 * workers, n_shards - first))]
            for blob in encode(
                    batch, window=window, literal=literal,
                    lazy_matching=lazy_matching, dictionary=dictionary,
                    device=dev):
                sizes.append(len(blob))
                dst.write(blob)
        end_at = dst.tell()
        dst.seek(sizes_at)
        dst.write(struct.pack(f"<{n_shards}I", *sizes))
        dst.seek(end_at)
        return end_at - head_at
    finally:
        if close_src:
            src.close()
        if close_dst:
            dst.close()


def decompress_sharded_device(blob: bytes, shard_size: int | None = None,
                              algorithm: str = "wavefront",
                              dictionary: bytes | None = None,
                              device=None) -> bytearray:
    """Decode a TTPU container on the card.

    ``algorithm="wavefront"`` (default): the per-bit parse, then the decode
    mode that ``TAMP_TPU_DECODE`` names (``commit``, ``chase`` or ``xla``;
    ``commit``, kernel B4, when it names none), ops/decode_wavefront.py.
    ``algorithm="serial"``: the token-serial decoder, kernel X2
    (ops/decode_serial.py).  ``shard_size`` (the per-shard output bound)
    comes from the v2 frame; pass it explicitly only for v1 containers.
    ``dictionary`` must match the encode side's."""
    raw_size, frame_shard_size, pieces = _parse_frame(blob)
    decode = _decoder(algorithm)
    outs = decode(pieces, max_out=_max_out(frame_shard_size, shard_size),
                  dictionary=dictionary, device=device)
    out = bytearray()
    for d in outs:
        out += d
    if len(out) != raw_size:
        raise ValueError("container raw-size mismatch")
    return out


def decompress_file_sharded(src, dst, workers: int | None = None,
                            dictionary: bytes | None = None, *,
                            shard_size: int | None = None,
                            algorithm: str = "wavefront",
                            device=None) -> int:
    """Bounded-memory TTPU decompression of a file on the card (the JAX
    package's ``decompress_file_sharded``, which decodes on host threads).

    Reads the frame header, then the shards in batches of at most
    ``2 * workers`` (default ``workers``: the CPU count, as in the JAX
    package), decodes each batch with one call of ``algorithm``'s decoder
    as :func:`decompress_sharded_device` does (``"wavefront"``: the mode of
    ``TAMP_TPU_DECODE``, kernel B4 by default; ``"serial"``: kernel X2),
    and writes its outputs to ``dst`` in order before the next batch is
    read.  ``src`` and ``dst`` are paths or binary files; ``src`` is read
    front to back, so it need not be seekable.  ``shard_size`` bounds each
    shard's output as in :func:`decompress_sharded_device` (from a v2
    frame; pass it for a v1 one).  Every shard must carry the first
    shard's header byte.  Raises ValueError for a bad magic, an unknown
    version, a truncated frame or shard, a header change and a written
    total other than the frame's raw size.  Returns the bytes written.

    Memory: on the host one batch's compressed and decoded bytes,
    ~2·workers·(shard_size + its stream); on the card the wavefront's ~100
    B a payload bit of one ``payload_groups`` group (at most
    ``GROUP_PAYLOAD_BYTES`` payload bytes, or one longer payload) beside
    the batch's (S, max_out) output, or for ``"serial"`` the batch's
    payloads and its (S, max_out) output."""
    from ..device import resolve_device

    decode = _decoder(algorithm)
    dev = resolve_device(device)
    if workers is None:
        workers = os.cpu_count() or 4
    close_src = close_dst = False
    if not hasattr(src, "read"):
        src, close_src = open(str(src), "rb"), True
    try:
        if not hasattr(dst, "write"):
            dst, close_dst = open(str(dst), "wb"), True
        raw_size, frame_shard_size, sizes = _read_head(src.read)
        max_out = _max_out(frame_shard_size, shard_size)
        head = None
        written = 0
        for first in range(0, len(sizes), 2 * workers):
            pieces = [_read_exact(src.read, sz)
                      for sz in sizes[first : first + 2 * workers]]
            if head is None:
                head = pieces[0][:1]
            if any(p[:1] != head for p in pieces):
                raise ValueError("shards must share one header configuration")
            for d in decode(pieces, max_out=max_out, dictionary=dictionary,
                            device=dev):
                written += len(d)
                dst.write(d)
        if written != raw_size:
            raise ValueError("container raw-size mismatch")
        return written
    finally:
        if close_src:
            src.close()
        if close_dst:
            dst.close()


def make_mesh(n_devices: int | None = None, axis: str = "dp", *,
              device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over the processes of the world,
    one device each (the JAX module's ``make_mesh``).

    ``device``: None for the CUDA card, each process on ``cuda:{local rank
    % device count}``; ``"cpu"`` for a CPU world.  Without a default
    process group this makes a world of one process (no port: a
    ``HashStore``); a world of several comes from
    :func:`tamp_tpu_torch.parallel.distributed.initialize`.  ``n_devices``,
    where given, must be the world size (ValueError)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    from .distributed import backend, local_rank

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the world has "
                         f"{world} processes")
    if not dist.is_initialized():
        dist.init_process_group(backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def _mesh_block(mesh, n_rows: int):
    """(group, device, rows of this rank) of a 1-D mesh: rank r holds the
    contiguous rows ``[r * n_rows / n, (r + 1) * n_rows / n)``, as
    ``PartitionSpec(axis)`` places them.  ``n_rows`` must divide over the
    mesh (ValueError, on every rank: no collective has run)."""
    import torch

    n = mesh.size()
    if n_rows == 0 or n_rows % n:
        raise ValueError(f"{n_rows} shards do not divide over a mesh of "
                         f"{n} devices")
    k = n_rows // n
    r = mesh.get_local_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return mesh.get_group(), dev, slice(r * k, (r + 1) * k)


def _gather_rows(t, group):
    """The (n * k, ...) concatenation of every rank's (k, ...) ``t``."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def estimate_bits(len16, window_bits: int, literal_bits: int):
    """Each shard's estimate of its compressed bits from its (k, L) cap-16
    lengths, in float32 (the JAX search step's): every position costs the
    cheaper of a literal (``1 + literal_bits``) and, where ``len16 >=
    minp``, its share of the cheapest match token, ``(2 + window_bits) /
    len16``; plus 8 for the header.  Returns (k,) float32."""
    import torch

    from ..constants import compute_min_pattern_size

    minp = compute_min_pattern_size(window_bits, literal_bits)
    lit = torch.tensor(1 + literal_bits, dtype=torch.float32,
                       device=len16.device)
    mcost = torch.where(
        len16 >= minp,
        (2 + window_bits) / torch.clamp_min(len16, 1).to(torch.float32), lit)
    return torch.minimum(mcost, lit).sum(1) + 8.0


def sharded_search_step(mesh, data, window_bits: int, literal_bits: int):
    """One data-parallel search step (the JAX module's
    ``sharded_search_step``): per-shard match tables and a cost estimate.

    ``data`` is the whole (S, L) uint8 array on every rank, S divisible by
    the mesh size.  Each rank runs kernel B5 once on its block of rows:
    the cap-16 v1 tables ``len16``, ``idx16`` against
    ``dictionary_array(W, literal=literal_bits)``, which equal the JAX
    step's ``mxu_chunk`` tables, and each shard's :func:`estimate_bits`.
    Returns ``{"len16", "idx16"}`` as the full (S, L) int32 tensors
    (``all_gather``) and ``"est_bits_total"``, the estimates' sum over
    every shard (``all_reduce``), a float32 scalar, on every rank's
    device."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..constants import compute_min_pattern_size
    from ..dictionary import dictionary_array
    from ..engine.pipeline import pad_shards
    from ..ops.match_v1 import v1_tables

    data = np.asarray(data, dtype=np.uint8)
    if data.ndim != 2:
        raise ValueError("data must be an (S, L) uint8 array")
    compute_min_pattern_size(window_bits, literal_bits)  # validates both
    group, dev, mine = _mesh_block(mesh, data.shape[0])
    L = data.shape[1]
    rows, npos = pad_shards(list(data[mine]))
    dict_arr = dictionary_array(1 << window_bits, literal=literal_bits)
    len16, idx16 = (t[:, :L] for t in v1_tables(
        torch.from_numpy(rows).to(dev), torch.from_numpy(npos).to(dev),
        torch.from_numpy(dict_arr).to(dev), window_bits=window_bits,
        cap=16))
    est = estimate_bits(len16, window_bits, literal_bits).sum()
    dist.all_reduce(est, group=group)
    return {"len16": _gather_rows(len16, group),
            "idx16": _gather_rows(idx16, group), "est_bits_total": est}


def sharded_decode_step(mesh, streams, *, max_out: int):
    """One data-parallel decode step (the JAX module's
    ``sharded_decode_step``).

    ``streams``: every rank's same list of same-header Tamp streams (default
    dictionary), their count divisible by the mesh size.  Each rank decodes
    its contiguous block in the groups of ``payload_groups`` with
    ``decode_group`` in ``resolve_mode()``'s mode: ``commit`` (kernel B4)
    unless ``TAMP_TPU_DECODE`` names another (``xla``: kernel X1's fold, the
    JAX step's mode).  One ``all_reduce`` sums the decoded lengths and the
    ranks' error flags: if any shard failed, every rank raises ValueError.
    Returns (outs (S, W) uint8, W = ``max_out``'s power-of-two bucket of
    at least 1024; lens (S,) int32; the total of lens, an int64 scalar),
    gathered on every rank's device."""
    import torch
    import torch.distributed as dist

    from ..ops.decode_wavefront import (
        _pow2_bucket, decode_group, payload_groups, resolve_mode,
        split_streams,
    )

    mode = resolve_mode()
    group, dev, mine = _mesh_block(mesh, len(streams))
    (window, literal, extended, more, dict_init, default_dict,
     payloads) = split_streams(streams, None)
    payloads = payloads[mine]
    outs = torch.zeros((len(payloads), _pow2_bucket(max_out, 1024)),
                       dtype=torch.uint8, device=dev)
    lens = torch.zeros(len(payloads), dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for i, j in payload_groups(payloads):
        if all(len(p) == 0 for p in payloads[i:j]):
            continue
        outs[i:j], lens[i:j], errs = decode_group(
            payloads[i:j], window=window, literal=literal, extended=extended,
            more=more, dict_init=dict_init, dict_reset=default_dict,
            max_out=max_out, device=dev, mode=mode)
        bad += (errs != 0).sum()
    # one collective for both: a rank that raised alone would leave the
    # others waiting in it
    sums = torch.stack([bad, lens.sum(dtype=torch.int64)])
    dist.all_reduce(sums, group=group)
    if int(sums[0]):
        raise ValueError("invalid tamp stream in sharded decode")
    return _gather_rows(outs, group), _gather_rows(lens, group), sums[1]

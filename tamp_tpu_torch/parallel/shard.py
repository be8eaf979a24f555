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

from .. import MAX_STREAM_BYTES

__all__ = ["make_mesh", "sharded_search_step", "sharded_decode_step",
           "compress_sharded", "compress_file_sharded", "decompress_sharded",
           "decompress_sharded_device", "decompress_file_sharded",
           "DEFAULT_SHARD_SIZE", "ENGINES"]

MAGIC = b"TTPU"
DEFAULT_SHARD_SIZE = 1 << 20
# The container encodes' engines: the JAX package's names, each a route on
# the card (see _route), and the port's device engines.
ENGINES = ("native", "tables", "optimal", "device-commit", "device-greedy",
           "device-optimal", "device")


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


def _check_shard(shard_size: int, n: int) -> None:
    """Refuse, before any read, allocation or launch, a real shard
    (``min(shard_size, n)`` of an ``n``-byte input) longer than one stream
    on the card may be (MAX_STREAM_BYTES, the int32 ranges of the encode
    kernels)."""
    if min(shard_size, n) > MAX_STREAM_BYTES:
        raise ValueError(
            f"a shard on the card is limited to {MAX_STREAM_BYTES} bytes "
            f"(MAX_STREAM_BYTES); shard_size={shard_size} is too large")


def _decode_limit(algorithm: str) -> int:
    """The largest per-shard output bound of ``algorithm``'s decoder:
    ``"serial"``, X2's MAX_DECODED (2**31 - 256: int output offsets, and
    the token crossing max_out runs up to 240 bytes past it);
    ``"wavefront"``, decode_wavefront.MAX_OUT (2**30: kernel B4 takes the
    power-of-two bucket of max_out as an int, and its packed words and
    nxt planes hold int32 bit offsets)."""
    if algorithm == "serial":
        from ..ops.decode_serial import MAX_DECODED

        return MAX_DECODED
    from ..ops.decode_wavefront import MAX_OUT

    return MAX_OUT


def _bound(raw_size: int, shard_size: int, algorithm: str,
           room: int = 0) -> int:
    """The per-shard output bound ``min(shard_size, raw_size)`` of a frame
    (at least 1), ValueError where it, plus ``room`` bytes the caller adds,
    is past ``algorithm``'s limit (:func:`_decode_limit`), before any
    allocation or launch."""
    bound = max(1, min(shard_size, raw_size))
    limit = _decode_limit(algorithm) - room
    if bound > limit:
        raise ValueError(
            f"a shard bound of {bound} bytes is past the {algorithm} "
            f"decoder's limit of {limit} bytes a shard")
    return bound


def _max_out(raw_size, frame_shard_size, shard_size, algorithm):
    """The per-shard output bound of a device decode: the caller's
    ``shard_size``, else the v2 frame's, else (a v1 frame)
    DEFAULT_SHARD_SIZE, as in the JAX package; cut to the raw size and
    checked against ``algorithm``'s limit (:func:`_bound`)."""
    if shard_size is None:
        shard_size = frame_shard_size
    if shard_size is None:
        shard_size = DEFAULT_SHARD_SIZE
    return _bound(raw_size, shard_size, algorithm)


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


def _route(engine: str, extended: bool) -> str:
    """The port's device engine for ``engine``: the JAX package's
    ``"native"`` (the reference greedy encoder) is ``"device-greedy"``
    (extended) or ``"device-commit"`` (v1), whose streams are that
    encoder's; ``"tables"`` is ``"device"`` (streams equal to
    ``encode_extended`` / ``encode_v1``); ``"optimal"`` is
    ``"device-optimal"``.  ValueError for a name not in :data:`ENGINES`
    (the JAX package writes its ``"tables"`` container for those)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    return {"native": "device-greedy" if extended else "device-commit",
            "tables": "device",
            "optimal": "device-optimal"}.get(engine, engine)


def _encoder(engine: str, extended: bool, workers: int | None):
    """The batch encoder of ``engine`` (see :func:`compress_sharded`):
    ``encode(shards, *, window, literal, lazy_matching, dictionary,
    device) -> list[bytes]``, one Tamp stream a shard."""
    engine = _route(engine, extended)
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
    engine: str = "native",
    device=None,
    workers: int | None = None,
) -> bytes:
    """Compress ``data`` as a TTPU container, all shards batched on the card.

    The JAX package's engine names are routes on the card, each writing the
    JAX package's container for that name (:func:`_route`):
    ``engine="native"`` (the default, as in the JAX package), the reference
    greedy encoder's streams: ``"device-greedy"`` (extended) or
    ``"device-commit"`` (v1); ``"tables"``: ``"device"``; ``"optimal"``:
    ``"device-optimal"``.  The device engines:
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
    whose streams are the same reference greedy ones (``encode_v1``).  An
    unknown name raises ValueError, and nothing falls back to another
    encoder.  ``dictionary`` (a full-window custom dictionary) seeds every
    shard's window; pass the same one to the decode side.  A shard longer
    than MAX_STREAM_BYTES raises ValueError.  ``device``: None for the CUDA
    card, ``"cpu"`` for the plain versions."""
    encode = _encoder(engine, extended, workers)
    _check_shard(shard_size, len(data))
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
    engine: str = "native",
    device=None,
) -> int:
    """Bounded-memory TTPU compression of a file (files larger than RAM),
    the JAX package's ``compress_file_sharded`` with its engine names
    (``"native"`` by default) as routes on the card, and the device engines
    ``"device"``, ``"device-greedy"`` and ``"device-optimal"``.

    Reads ``src`` shard by shard, up to ``2 * workers`` shards at a time
    (default ``workers``: the CPU count + 2, as in the JAX package),
    encodes each such batch with one call of ``engine``'s batch encode
    (see :func:`compress_sharded`; ``"native"``: ``"device-greedy"``,
    kernels B5 and B7 once and the host greedy committer, or v1
    ``"device-commit"``; ``"tables"`` / ``"device"``: one launch of kernel
    B5 and the host committer on ``workers`` threads,
    engine/pipeline.encode_device_batch; ``"optimal"`` /
    ``"device-optimal"``: kernel X4, or v1 B5, X3 and B3), and writes the
    streams to ``dst`` in order: the frame header and a zeroed sizes table
    go out first and the sizes are patched in place at the end, so ``dst``
    must be seekable (a path or a binary file).  The output is byte-identical
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

    ``engine="device-commit"`` raises ValueError, as in the JAX package.
    The JAX package's own function writes its ``"tables"`` container for
    any engine name it does not know; the port refuses them (ValueError).
    A shard longer than MAX_STREAM_BYTES raises ValueError before ``src``
    is read."""
    if engine == "device-commit":
        raise ValueError(
            "device-commit batches whole containers; use compress_sharded, "
            "or engine='device' for the per-shard device search pipeline")
    from ..device import resolve_device

    if workers is None:
        workers = (os.cpu_count() or 4) + 2
    encode = _encoder(engine, extended, workers)
    dev = resolve_device(device)
    close_src = close_dst = False
    if not hasattr(src, "read"):
        src, close_src = open(str(src), "rb"), True
    try:
        pos0 = src.tell()
        raw_size = src.seek(0, 2) - pos0
        src.seek(pos0)
        _check_shard(shard_size, raw_size)
        if not hasattr(dst, "write"):
            dst, close_dst = open(str(dst), "wb"), True
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
    comes from the v2 frame; pass it explicitly only for v1 containers
    (else DEFAULT_SHARD_SIZE bounds each shard, as in the JAX package; the
    host-signature :func:`decompress_sharded` needs no bound).  A bound,
    cut to the raw size, past the decoder's limit (:func:`_decode_limit`)
    raises ValueError.  ``dictionary`` must match the encode side's."""
    raw_size, frame_shard_size, pieces = _parse_frame(blob)
    decode = _decoder(algorithm)
    outs = decode(pieces, max_out=_max_out(raw_size, frame_shard_size,
                                           shard_size, algorithm),
                  dictionary=dictionary, device=device)
    out = bytearray()
    for d in outs:
        out += d
    if len(out) != raw_size:
        raise ValueError("container raw-size mismatch")
    return out


def _stream_decoder(pieces, *, max_out, dictionary, device) -> list:
    """A batch decoder of v1-frame shards, whose decoded sizes the frame
    does not bound: each shard through ops/decode_serial.decode_stream
    (kernel X2 from a room of 8 bytes a payload byte, four times larger
    while the output fills it; the native decoder's errors).  ``max_out``
    is not used."""
    from ..ops.decode_serial import decode_stream

    return [bytes(decode_stream(p, dictionary=dictionary, device=device))
            for p in pieces]


def decompress_sharded(blob: bytes, workers: int | None = None,
                       dictionary: bytes | None = None, *,
                       device=None) -> bytearray:
    """Decode a TTPU container on the card: the JAX package's
    ``decompress_sharded`` (the threaded native decoder) with its
    signature, its output and its errors, on kernel X2.

    A v2 frame: the shards go in batches of ``2 * workers`` (default
    ``workers``: the CPU count), one X2 launch a batch and header byte, at
    the frame's per-shard bound ``min(shard_size, raw_size)`` plus one byte,
    and each shard's bytes land in its ``i * shard_size`` slice of one
    output allocated up front.  A shard that decodes past its slice raises
    ValueError("decoded stream exceeds the provided buffer"), one short of
    it ValueError("container raw-size mismatch"), as in the JAX package.
    A v1 frame (no per-shard bound): each shard through
    ops/decode_serial.decode_stream, whose room grows with the output.
    A reference outside the window raises OutOfBoundsError, a bad header
    or a custom-dictionary stream without its dictionary ValueError, and a
    bound past X2's MAX_DECODED ValueError before any launch.
    ``dictionary`` must match the encode side's.  ``device``: None for the
    CUDA card, ``"cpu"`` for the plain versions."""
    from ..device import resolve_device
    from ..ops.decode_serial import decode_shards_device

    dev = resolve_device(device)
    raw_size, shard_size, pieces = _parse_frame(blob)
    if shard_size is None:
        out = bytearray(b"".join(_stream_decoder(
            pieces, max_out=None, dictionary=dictionary, device=dev)))
        if len(out) != raw_size:
            raise ValueError("container raw-size mismatch")
        return out
    # one byte past the bound tells a shard that overflows its slice
    max_out = _bound(raw_size, shard_size, "serial", room=1) + 1
    if workers is None:
        workers = os.cpu_count() or 4
    out = bytearray(raw_size)
    for first in range(0, len(pieces), 2 * workers):
        batch = pieces[first : first + 2 * workers]
        # one launch a header byte; an empty stream, or a ``more`` one
        # without its reserved byte, decodes to nothing (the native decoder)
        groups: dict[int, list[int]] = {}
        for k, p in enumerate(batch):
            if p and not (p[0] & 1 and len(p) < 2):
                groups.setdefault(p[0], []).append(k)
        got = [b""] * len(batch)
        for ks in groups.values():
            for k, d in zip(ks, decode_shards_device(
                    [batch[k] for k in ks], dictionary=dictionary,
                    max_out=max_out, device=dev)):
                got[k] = d
        for k, d in enumerate(got):
            start = (first + k) * shard_size
            end = min(start + shard_size, raw_size)
            if len(d) > max(0, end - start):
                raise ValueError("decoded stream exceeds the provided buffer")
            if len(d) != end - start:
                raise ValueError("container raw-size mismatch")
            out[start:end] = d
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
    frame, or the caller's); a v1 frame without a caller bound decodes
    shard by shard with kernel X2's growing room
    (ops/decode_serial.decode_stream), as :func:`decompress_sharded` does.
    Every shard must carry the first shard's header byte.  Raises
    ValueError for a bad magic, an unknown version, a truncated frame or
    shard, a header change, a bound past the decoder's limit and a written
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
        if frame_shard_size is None and shard_size is None:
            decode = _stream_decoder
            max_out = None
        else:
            max_out = _max_out(raw_size, frame_shard_size, shard_size,
                               algorithm)
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

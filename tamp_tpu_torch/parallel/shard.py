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
"""

from __future__ import annotations

import os
import struct

__all__ = ["compress_sharded", "compress_file_sharded",
           "decompress_sharded_device", "DEFAULT_SHARD_SIZE"]

MAGIC = b"TTPU"
DEFAULT_SHARD_SIZE = 1 << 20


def _pack_frame(blobs, raw_size: int, shard_size: int) -> bytes:
    """TTPU v2 frame: records shard_size so decoders can place every
    shard's output at ``i * shard_size`` without decoding in order."""
    head = MAGIC + struct.pack("<BBIQQ", 2, 0, len(blobs), raw_size,
                               shard_size)
    sizes = struct.pack(f"<{len(blobs)}I", *(len(b) for b in blobs))
    return head + sizes + b"".join(blobs)


def _parse_frame(blob):
    """-> (raw_size, shard_size | None, pieces).  Reads v1 (no shard_size)
    and v2 frames."""
    if blob[:4] != MAGIC:
        raise ValueError("not a TTPU container")
    ver, _res, n, raw_size = struct.unpack_from("<BBIQ", blob, 4)
    off = 4 + 14
    shard_size = None
    if ver == 2:
        (shard_size,) = struct.unpack_from("<Q", blob, off)
        off += 8
    elif ver != 1:
        raise ValueError(f"unsupported TTPU version {ver}")
    sizes = struct.unpack_from(f"<{n}I", blob, off)
    off += 4 * n
    pieces = []
    for sz in sizes:
        pieces.append(blob[off : off + sz])
        off += sz
    return raw_size, shard_size, pieces


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
    the JAX package's ``compress_file_sharded`` with ``engine="device"``.

    Reads ``src`` shard by shard, up to ``2 * workers`` shards at a time
    (default ``workers``: the CPU count + 2, as in the JAX package),
    encodes each such batch with one launch of kernel B5 and the host
    committer on ``workers`` threads (engine/pipeline.encode_device_batch),
    and writes the streams to ``dst`` in order: the frame header and a
    zeroed sizes table go out first and the sizes are patched in place at
    the end, so ``dst`` must be seekable (a path or a binary file).  The
    output is byte-identical to ``compress_sharded(engine="device")`` on
    the whole file.  Returns the bytes written.

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

    Only ``engine="device"`` streams: ``"device-commit"`` (and the other
    engines, which batch whole containers) raise ValueError.  The JAX
    package's own function writes its ``"tables"`` container for any
    engine name it does not know; the port refuses them instead."""
    if engine == "device-commit":
        raise ValueError(
            "device-commit batches whole containers; use compress_sharded, "
            "or engine='device' for the per-shard device search pipeline")
    if engine != "device":
        raise ValueError(
            f"compress_file_sharded streams engine='device' only; use "
            f"compress_sharded for engine={engine!r}")
    from ..device import resolve_device
    from ..engine.pipeline import encode_device_batch

    dev = resolve_device(device)
    if workers is None:
        workers = (os.cpu_count() or 4) + 2
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
            for blob in encode_device_batch(
                    batch, window=window, literal=literal, extended=extended,
                    lazy_matching=lazy_matching, dictionary=dictionary,
                    device=dev, workers=workers):
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
    if shard_size is None:
        shard_size = frame_shard_size
    if shard_size is None:
        shard_size = DEFAULT_SHARD_SIZE  # v1 frame without a caller bound
    if algorithm == "wavefront":
        from ..ops.decode_wavefront import decode_shards_wavefront as decode
    elif algorithm == "serial":
        from ..ops.decode_serial import decode_shards_device as decode
    else:
        raise ValueError(f"unknown device decode algorithm: {algorithm!r}")
    outs = decode(pieces, max_out=shard_size, dictionary=dictionary,
                  device=device)
    out = bytearray()
    for d in outs:
        out += d
    if len(out) != raw_size:
        raise ValueError("container raw-size mismatch")
    return out

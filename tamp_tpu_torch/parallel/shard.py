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

import struct

__all__ = ["compress_sharded", "decompress_sharded_device",
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
) -> bytes:
    """Compress ``data`` as a TTPU container, all shards batched on the card.

    ``engine="device-commit"``, byte-identical to the JAX package's
    ``compress_sharded(engine="device-commit")``: the extended-format
    planned encode (engine/pipeline_ext.py) or, with ``extended=False``,
    the v1 encode (engine/pipeline.py), each with or without
    ``lazy_matching``.  ``engine="device-greedy"`` (extended only): tables
    on the card, the greedy walk in the host committer; every shard's
    stream is byte-identical to the reference greedy encoder
    (engine/pipeline_ext.encode_ext_device_greedy).  ``dictionary`` (a
    full-window custom dictionary) seeds every shard's window; pass the
    same one to the decode side.  ``device``: None for the CUDA card,
    ``"cpu"`` for the plain versions."""
    if engine == "device-greedy":
        if not extended:
            raise ValueError("device-greedy is the extended-format mode; "
                             "v1 engine='device-commit' is already "
                             "reference-exact")
        from ..engine.pipeline_ext import encode_ext_device_greedy as encode
    elif engine != "device-commit":
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: ROADMAP.md queue A "
            "('Optimal modes' for device-optimal, item 7 for device)")
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

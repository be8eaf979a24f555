"""PyTorch + CUDA port of tamp_tpu.

The front door, on the NVIDIA card unless ``device="cpu"`` is asked for:

- :func:`compress` / :func:`decompress`: one Tamp stream, byte-equal to
  ``tamp_tpu.compress`` / ``tamp_tpu.decompress`` (the reference greedy
  encoder, ``parse="optimal"``'s minimum-bit parse, the native decoder),
  errors included;
- ``python -m tamp_tpu_torch compress|decompress|build-dictionary``
  (:mod:`tamp_tpu_torch.cli.main`), whose outputs equal ``python -m
  tamp_tpu``'s;
- the TTPU containers of independent streams:
  :func:`tamp_tpu_torch.parallel.shard.compress_sharded` (engines
  ``"device-commit"``, ``"device-greedy"``, ``"device-optimal"``,
  ``"device"``), ``compress_file_sharded``, ``decompress_sharded_device``
  (every device decode mode of the JAX package and
  ``algorithm="serial"``) and ``decompress_file_sharded``.

Extended and v1 formats, lazy matching on and off, windows 8-15, literals
5-8.  The package imports PyTorch and NumPy only; its CUDA kernels
(``csrc/*.cu``) are built with ``nvcc``, and its host greedy committer
(``csrc/greedy_commit.cpp``) with the host C++ compiler, at first use
(:mod:`tamp_tpu_torch.ops._build`).
"""

from .constants import compute_min_pattern_size
from .dictionary import dictionary_array, initialize_dictionary
from .exceptions import ExcessBitsError, OutOfBoundsError

__all__ = ["compress", "decompress", "initialize_dictionary",
           "compute_min_pattern_size", "bit_size", "dictionary_array",
           "ExcessBitsError", "OutOfBoundsError", "MAX_STREAM_BYTES"]

# The longest input one stream may have.  The encodes pad a stream to a
# power of two of positions; at 2**27 a stream of literals (9 bits a byte)
# stays below 2**31 bits and its decode below X2's output limit, so no
# kernel's int32 position, bit count or max_out can pass its range.
MAX_STREAM_BYTES = 1 << 27


def compress(data, *, window: int = 10, literal: int = 8,
             extended: bool = True, lazy_matching: bool = False,
             dictionary=None, parse: str = "greedy", device=None) -> bytes:
    """One Tamp stream of ``data``, byte-equal to ``tamp_tpu.compress``.

    Routes, the whole input as one shard on the card:

    - extended: kernel B5's cap-16 tables (and the lazy probe), kernel B7's
      start prediction and the host greedy committer
      (engine/pipeline_ext.encode_ext_device_greedy), the reference greedy
      encoder's stream;
    - v1: kernels B5 and B3, or under lazy matching B5 with the probe and
      B6 (engine/pipeline.encode_v1_device_commit);
    - ``parse="optimal"``: the minimum-bit parse, kernel X4 (extended) or
      B5, X3 and B3 (v1); ``lazy_matching`` does not apply.

    Raises ValueError for a window outside 8-15, a literal outside 5-8, a
    ``dictionary`` that is not ``1 << window`` bytes, and an input longer
    than :data:`MAX_STREAM_BYTES`; ExcessBitsError for a byte wider than
    ``literal`` bits.  ``device``: None for the CUDA card (RuntimeError
    without one), ``"cpu"`` for the plain versions of the kernels."""
    if parse not in ("greedy", "optimal"):
        raise ValueError(f"parse must be 'greedy' or 'optimal', not {parse!r}")
    compute_min_pattern_size(window, literal)  # validates the config
    data = bytes(data)
    if dictionary is not None:
        dictionary = bytes(dictionary)
        if len(dictionary) != 1 << window:
            raise ValueError("Dictionary-window size mismatch.")
    if len(data) > MAX_STREAM_BYTES:
        raise ValueError(
            f"one stream on the card is limited to {MAX_STREAM_BYTES} "
            "bytes; use tamp_tpu_torch.parallel.shard.compress_sharded for "
            "larger inputs")
    kw = dict(window=window, literal=literal, dictionary=dictionary,
              device=device)
    if parse == "optimal":
        if extended:
            from .engine.pipeline_ext import encode_ext_device_optimal as enc
        else:
            from .engine.pipeline import encode_v1_device_optimal as enc
        return enc([data], **kw)[0]
    if extended:
        from .engine.pipeline_ext import encode_ext_device_greedy as enc
    else:
        from .engine.pipeline import encode_v1_device_commit as enc
    return enc([data], lazy_matching=lazy_matching, **kw)[0]


def decompress(data, *, dictionary=None, device=None) -> bytearray:
    """Decode one Tamp stream on the card with kernel X2, byte-equal to
    ``tamp_tpu.decompress``: OutOfBoundsError for a reference outside the
    window, ValueError for a bad header or a custom-dictionary stream
    without its dictionary, and for a stream decoding to more than X2's
    limit (ops/decode_serial.MAX_DECODED).  ``device``: as
    :func:`compress`."""
    from .ops.decode_serial import decode_stream

    return decode_stream(data, dictionary=dictionary, device=device)


def bit_size(value: int) -> int:
    """Number of bits needed to represent ``value`` (0 for 0; -1 if 32+ bits)."""
    for i in range(32):
        if not value:
            return i
        value >>= 1
    return -1

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
  :func:`tamp_tpu_torch.parallel.shard.compress_sharded` (the JAX engine
  names ``"native"`` (the default), ``"tables"`` and ``"optimal"`` as
  routes on the card, and ``"device-commit"``, ``"device-greedy"``,
  ``"device-optimal"``, ``"device"``), ``compress_file_sharded``,
  ``decompress_sharded`` (kernel X2 a batch of shards),
  ``decompress_sharded_device`` (every device decode mode of the JAX
  package and ``algorithm="serial"``) and ``decompress_file_sharded``.

The streaming codec is host code, as in the JAX package: :func:`open`,
:class:`Compressor` / :class:`Decompressor` and their ``Text*`` forms (the
port's copies of the Python codec) and, for binary modes by default, the
C++ streams of :mod:`tamp_tpu_torch.stream` with progress callbacks.  A
mid-stream flush leaves a window state no device encoder models, and a
write of a few bytes is work a launch could only slow; these classes take
no ``device``.

Extended and v1 formats, lazy matching on and off, windows 8-15, literals
5-8.  The package imports PyTorch and NumPy only; its CUDA kernels
(``csrc/*.cu``) are built with ``nvcc``, and its host greedy committer
and streams (``csrc/greedy_commit.cpp``, ``csrc/stream.cpp``) with the
host C++ compiler, at first use (:mod:`tamp_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"

from .compressor import Compressor, TextCompressor
from .constants import compute_min_pattern_size
from .decompressor import Decompressor, TextDecompressor
from .dictionary import dictionary_array, initialize_dictionary
from .exceptions import AbortedError, ExcessBitsError, OutOfBoundsError

__all__ = ["compress", "decompress", "initialize_dictionary",
           "compute_min_pattern_size", "bit_size", "dictionary_array",
           "Compressor", "TextCompressor", "Decompressor",
           "TextDecompressor", "open", "AbortedError", "ExcessBitsError",
           "OutOfBoundsError", "MAX_STREAM_BYTES", "__version__"]

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


def open(f, mode: str = "rb", *, implementation: str = "auto", **kwargs):
    """Open a Tamp stream for reading (decompression) or writing
    (compression), as ``tamp_tpu.open`` does: ``"r"``/``"rb"`` give a
    (Text)Decompressor, ``"w"``/``"wb"`` a (Text)Compressor; binary modes
    take bytes, text modes str.

    ``implementation``: ``"auto"`` and ``"native"`` give the C++ streams
    (:mod:`tamp_tpu_torch.stream`) for binary modes, ``"python"`` the
    Python codec; text modes are always Python.  Host code: no device."""
    if "r" in mode and "w" in mode:
        raise ValueError(f"Cannot open in both read and write mode: {mode!r}")
    if implementation not in ("auto", "python", "native"):
        raise ValueError(f"Unknown implementation: {implementation!r}")
    native = implementation != "python" and "b" in mode
    if "r" in mode:
        if native:
            from .stream import NativeDecompressor

            return NativeDecompressor(f, **kwargs)
        cls = Decompressor if "b" in mode else TextDecompressor
        return cls(f, **kwargs)
    if "w" in mode:
        if native:
            from .stream import NativeCompressor

            return NativeCompressor(f, **kwargs)
        cls = Compressor if "b" in mode else TextCompressor
        return cls(f, **kwargs)
    raise ValueError(f"Invalid mode: {mode!r}")

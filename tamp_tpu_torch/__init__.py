"""PyTorch + CUDA port of tamp_tpu's device path.

The TTPU container round trip on an NVIDIA Hopper card, extended and v1
formats, lazy matching on and off, windows 8-15, literals 5-8:

- encode: :func:`tamp_tpu_torch.parallel.shard.compress_sharded`
  (``engine="device-commit"``);
- decode: :func:`tamp_tpu_torch.parallel.shard.decompress_sharded_device`,
  every device decode mode of the JAX package (``commit``, ``chase``,
  ``xla``; ``TAMP_TPU_DECODE``) and ``algorithm="serial"``.

Streams and containers are byte-identical to the JAX package's.  The
package imports PyTorch and NumPy only; its CUDA kernels (``csrc/``) are
built with ``nvcc`` at first use (:mod:`tamp_tpu_torch.ops._build`).
"""

from .dictionary import dictionary_array
from .exceptions import ExcessBitsError, OutOfBoundsError

__all__ = ["dictionary_array", "ExcessBitsError", "OutOfBoundsError"]

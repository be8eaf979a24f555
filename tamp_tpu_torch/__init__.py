"""PyTorch + CUDA port of tamp_tpu's device path.

The TTPU container round trip of the format default (extended format,
window 10, literal 8, no lazy matching) on an NVIDIA Hopper card:

- encode: :func:`tamp_tpu_torch.parallel.shard.compress_sharded`
  (``engine="device-commit"``);
- decode: :func:`tamp_tpu_torch.parallel.shard.decompress_sharded_device`.

Streams and containers are byte-identical to the JAX package's.  The
package imports PyTorch and NumPy only; its CUDA kernels (``csrc/``) are
built with ``nvcc`` at first use (:mod:`tamp_tpu_torch.ops._build`).
"""

from .dictionary import dictionary_array
from .exceptions import ExcessBitsError, OutOfBoundsError

__all__ = ["dictionary_array", "ExcessBitsError", "OutOfBoundsError"]

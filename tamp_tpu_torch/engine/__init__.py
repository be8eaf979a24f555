"""Encode engines of the port (the JAX package's ``tamp_tpu.engine``).

:func:`encode_device` is ``engine="device"``'s one-shot (extended: kernel
B5's tables on the card and the host table committer; v1: the card's v1
encode), :func:`encode_extended` its extended-format stream,
:func:`encode_v1` one v1 stream on the card (the greedy or the optimal
parse), and :func:`device_pipeline_available` says whether a CUDA card is
visible.  The batch encodes behind ``compress_sharded``'s engines live in
:mod:`.pipeline` and :mod:`.pipeline_ext`.
"""

from .encode_extended import encode_extended  # noqa: F401
from .pipeline import (  # noqa: F401
    device_pipeline_available,
    encode_device,
    encode_v1,
)

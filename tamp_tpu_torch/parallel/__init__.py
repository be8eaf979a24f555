"""Data-parallel sharded compression: TTPU containers of independent Tamp
streams (``shard.py``) and the mesh layer on ``torch.distributed``
(``shard.make_mesh`` and the two steps, ``distributed.py``).  The JAX
package's host decoder ``decompress_sharded`` is not ported; the port
decodes on the card (``decompress_sharded_device``)."""

from .shard import (  # noqa: F401
    compress_sharded,
    decompress_sharded_device,
    make_mesh,
    sharded_decode_step,
    sharded_search_step,
)

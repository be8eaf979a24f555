"""Data-parallel sharded compression: TTPU containers of independent Tamp
streams (``shard.py``) and the mesh layer on ``torch.distributed``
(``shard.make_mesh`` and the two steps, ``distributed.py``).  The container
encodes take the JAX package's engine names (``"native"`` by default) as
routes on the card.  Every decode runs on the card: ``decompress_sharded``
(the JAX package's host decoder's signature and errors, kernel X2 a batch
of shards), ``decompress_sharded_device`` of a whole container in any
device mode, and ``decompress_file_sharded`` of a file, batch by batch."""

from .shard import (  # noqa: F401
    compress_file_sharded,
    compress_sharded,
    decompress_file_sharded,
    decompress_sharded,
    decompress_sharded_device,
    make_mesh,
    sharded_decode_step,
    sharded_search_step,
)

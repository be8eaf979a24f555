"""Data-parallel sharded compression: TTPU containers of independent Tamp
streams (``shard.py``) and the mesh layer on ``torch.distributed``
(``shard.make_mesh`` and the two steps, ``distributed.py``).  Every decode
runs on the card: ``decompress_sharded_device`` of a whole container and
``decompress_file_sharded`` of a file, batch by batch.  The JAX package's
host decoder ``decompress_sharded`` (threaded native) is not ported."""

from .shard import (  # noqa: F401
    compress_file_sharded,
    compress_sharded,
    decompress_file_sharded,
    decompress_sharded_device,
    make_mesh,
    sharded_decode_step,
    sharded_search_step,
)

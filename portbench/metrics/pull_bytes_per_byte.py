"""``pull_bytes_per_byte`` (engines): the bytes the encode copies from the
card to the host a byte of input: ``encode.pull_bytes`` (B7's start bitmap
and the entry words pulled, or v1's state rows and body block) over
``encode.raw_bytes``, both counted by ``tamp_tpu_torch.trace`` over the
traced calls."""


def read(run):
    if run.trace is None:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the counters
        return None
    c = trace.snapshot().counters
    if "encode.pull_bytes" not in c or not c.get("encode.raw_bytes"):
        return None
    return c["encode.pull_bytes"] / c["encode.raw_bytes"]

"""``ring_tail_ms`` (engines): the v1 encode's host ring tail
(``finish_streams``: each shard's last < 16 bytes and its stream joined),
the ``tamp.encode.tail`` spans' host ms a traced call."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    spans = [s for s in trace.snapshot().spans if s.name == "tamp.encode.tail"]
    if not spans:
        return None
    return sum(s.ms for s in spans) / run.trace.calls

"""``x2_host_copy_ms`` (container API): the container decode's host copies
of X2's output (the zeroed output, a ``bytes`` a shard, the slice copies
into the output), the ``tamp.decode.copy`` spans' host ms a traced
call."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    spans = [s for s in trace.snapshot().spans if s.name == "tamp.decode.copy"]
    if not spans:
        return None
    return sum(s.ms for s in spans) / run.trace.calls

"""``parse_device_ms`` (decode pipeline): the card's time in the per-bit
parse (``payload_parse``'s tensor ops), from the CUDA events of the
``tamp.decode.parse`` spans, ms a traced call."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    ms = [s.device_ms for s in trace.snapshot().spans
          if s.name == "tamp.decode.parse" and s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / run.trace.calls

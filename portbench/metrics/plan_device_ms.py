"""``plan_device_ms`` (engines): the card's time in the planned encode's
field planner (the region planes and the sentinel fill, then
``plan_fields_ext``'s tensor ops), from the CUDA events of the
``tamp.encode.plan`` spans, ms a traced call."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    ms = [s.device_ms for s in trace.snapshot().spans
          if s.name == "tamp.encode.plan" and s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / run.trace.calls

"""``ext_prep_ms_per_mib`` (engines): the planned encode's host prep (the
run plan, the model history and the chunk counts, the C++
``tpt_ext_prep``) in thread time a MiB of input: the summed
``tamp.encode.prep.shard`` spans (one a shard, in the prep's worker
threads) over the traced calls' ``encode.raw_bytes`` in MiB (program spans
and counters of ``tamp_tpu_torch.trace``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    snap = trace.snapshot()
    ms = sum(s.ms for s in snap.spans if s.name == "tamp.encode.prep.shard")
    raw = snap.counters.get("encode.raw_bytes", 0)
    if not ms or not raw:
        return None
    return ms / (raw / (1 << 20))

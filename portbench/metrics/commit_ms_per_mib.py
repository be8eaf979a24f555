"""``commit_ms_per_mib`` (host committer): the host greedy committer's
thread time a MiB of input: the summed ``tamp.encode.commit.shard`` spans
(one a shard, in the committer's worker threads) over the traced calls'
``encode.raw_bytes`` in MiB (program spans and counters of
``tamp_tpu_torch.trace``, on while the harness's profiler runs)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the spans
        return None
    snap = trace.snapshot()
    ms = sum(s.ms for s in snap.spans if s.name == "tamp.encode.commit.shard")
    raw = snap.counters.get("encode.raw_bytes", 0)
    if not ms or not raw:
        return None
    return ms / (raw / (1 << 20))

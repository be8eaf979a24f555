"""``b7_hit_share`` (host committer): the share of the committer's table
lookups that took the card's entry without a search, in %
(``commit.table_hits`` over ``commit.lookups``, counted by the C++
committer and added up by ``tamp_tpu_torch.trace`` while the harness's
profiler runs); the rest are searches at B7's holes, or seeded or full
searches after a window truncation."""


def read(run):
    if run.trace is None:
        return None
    try:
        from tamp_tpu_torch import trace
    except ImportError:  # a program without the counters
        return None
    c = trace.snapshot().counters
    if not c.get("commit.lookups"):
        return None
    return 100.0 * c.get("commit.table_hits", 0) / c["commit.lookups"]

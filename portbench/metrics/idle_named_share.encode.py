"""``idle_named_share.encode`` (device): the share of the card's idle time in
the traced window that the trace can name, in %: idle gaps whose label is
a host op or a span over the gap's middle, not ``host, no op`` (the
harness's label where the host ran none)."""


def read(run):
    if run.trace is None:
        return None
    idle = sum(run.trace.gaps.values())
    if idle <= 0:
        return None
    named = sum(s for label, s in run.trace.gaps.items()
                if not label.startswith("host, no op"))
    return 100.0 * named / idle

"""``ratio``: container bytes over raw bytes of the pool's first pass (each
distinct input once), so a seed fixes it exactly."""


def read(run):
    first = run.calls[: len(run.inputs)]
    raw = sum(c.raw_bytes for c in first if c.ok)
    if not raw:
        return None
    return sum(c.packed_bytes for c in first if c.ok) / raw

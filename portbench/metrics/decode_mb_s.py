"""``decode_mb_s``: raw bytes out (10^6) of every completed call over the
window's time, first call's start to last call's end (host clock)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.raw_bytes for c in run.calls if c.ok) / run.window_s / 1e6

"""``encode_mb_s.host`` (container API): raw bytes (10^6) of every
completed call over the window's time, first call's start to last call's
end (host clock).  The encode cells' card idles most of the window, so
the rate follows the host's speed, which swings by more than an
end-to-end bound may hold: it is reported beside ``ratio``, per layer."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.raw_bytes for c in run.calls if c.ok) / run.window_s / 1e6

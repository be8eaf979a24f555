"""``decode_p95_ms``: the 95th percentile of every call's time in the
window, failed calls included (host clock)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.end - c.start for c in run.calls], 95)
                 * 1e3)

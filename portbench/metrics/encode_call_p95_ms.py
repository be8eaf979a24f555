"""``encode_call_p95_ms`` (container API): the 95th percentile of the
encode calls' host times in the traced run's window (host-paced, so a
per-layer number beside ``encode_mb_s.host``)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.end - c.start for c in run.calls], 95)
                 * 1e3)

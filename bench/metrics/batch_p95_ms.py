"""batch_p95_ms: the 95th percentile (linear between order statistics)
over every call of the window, each timed from the hand-over of its batch
until its answers were on the host."""
import numpy as np


def read(m):
    calls = m.get("calls_s")
    return float(np.percentile(calls, 95)) * 1e3 if calls else None

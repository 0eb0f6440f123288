"""The arithmetic of the end-to-end metrics.

Every metric is taken over all the requests sent in the window: no medians
of chunks, no rolling windows.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def qps(records: Sequence[dict], start: float) -> float:
    """Requests answered per second: every request sent in the window,
    over the time from the window's start to the last answer. The window
    sends no request after its close and waits for those out, so a rate
    over whole batches is not cut at a batch's edge."""
    done = [r["t_done"] for r in records if r["t_done"] is not None]
    return len(done) / (max(done) - start)


def recall(returned: np.ndarray, exact: np.ndarray) -> float | None:
    """|returned ∩ exact| / |exact| for one request (ids -1 padded); None
    where the filter matches no record."""
    want = set(int(x) for x in exact if x >= 0)
    if not want:
        return None
    got = set(int(x) for x in returned if x >= 0)
    return len(got & want) / len(want)


def mean_recall(pairs) -> float:
    """Mean of :func:`recall` over (returned, exact) pairs, leaving out the
    requests whose filter matches nothing."""
    vals = [v for v in (recall(a, b) for a, b in pairs) if v is not None]
    if not vals:
        raise ValueError("no request has a non-empty exact answer")
    return float(np.mean(vals))

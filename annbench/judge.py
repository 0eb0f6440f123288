"""The comparison that decides ``correct``.

Every answer served in the window is compared with the plain reference
(``reference.py``), once the program's state is freed. Five numbers are
compared, each against the limit of the cell's ``limits/<cell>.json``:

- ``unanswered``: requests submitted in the window that never came back or
  failed (exact: limit 0);
- ``filter_violations``: returned ids that do not exist, do not carry
  every tag of the request's filter or have a numeric field outside its
  range, from the generated arrays (exact: limit 0);
- ``duplicate_ids``: ids returned twice in one answer (exact: limit 0);
- ``dist_gap``: the largest relative gap between a returned distance and
  the reference's squared L2 distance of the same id, which ties each id to
  its distance (its limit lies between the program's and the control's
  readings; PERF.md gives them);
- ``recall_shortfall``: 1 - the mean over the answers of |returned ids ∩
  the exact filtered top-k| ÷ |exact top-k|, which holds the ids to the
  exact answer (its limit lies between the program's readings and the
  least of those of the control and of a fault planted in the program: a
  hop loop cut short, or the ``pre`` route's re-rank pool cut; PERF.md
  gives them).
"""
from __future__ import annotations

import numpy as np

from annbench import stats

NAMES = ("unanswered", "filter_violations", "duplicate_ids", "dist_gap",
         "recall_shortfall")


def compare(answers, unanswered: int, queries: np.ndarray,
            q_tags: np.ndarray, q_ranges: np.ndarray, exact: np.ndarray,
            ref) -> dict:
    """The five numbers. ``answers`` is a list of (pool index, ids,
    dists); ``queries``/``q_tags``/``q_ranges`` are the pool's and
    ``exact`` its exact filtered top-k ids (-1 padded, from
    ``ref.search``); ``ref`` a :class:`reference.Reference`."""
    violations = dups = 0
    gap = 0.0
    block = 4096
    for s in range(0, len(answers), block):
        part = answers[s:s + block]
        width = max([len(a[1]) for a in part] + [1])
        ids = np.full((len(part), width), -1, np.int64)
        dists = np.full((len(part), width), np.nan, np.float64)
        for i, (_, a_ids, a_d) in enumerate(part):
            ids[i, :len(a_ids)] = a_ids
            dists[i, :len(a_d)] = a_d
        rows = np.array([a[0] for a in part], np.int64)
        live = ids >= 0
        ok = ref.filter_ok(q_tags[rows], q_ranges[rows], ids)
        violations += int((live & ~ok).sum())
        for row in ids:
            got = row[row >= 0]
            dups += int(got.size - np.unique(got).size)
        d_ref = ref.distances(queries[rows], ids)
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(dists - d_ref) / np.maximum(d_ref, 1e-30)
        rel = np.where(live & ok, rel, 0.0)
        if np.isnan(rel).any():
            gap = np.inf
        elif rel.size:
            gap = max(gap, float(rel.max()))
    pairs = [(ids, exact[row]) for row, ids, _ in answers]
    shortfall = 1.0 - stats.mean_recall(pairs) if answers else 1.0
    return {"unanswered": int(unanswered), "filter_violations": violations,
            "duplicate_ids": dups, "dist_gap": gap,
            "recall_shortfall": shortfall}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}
    return all(numbers[k] <= limits[k] for k in NAMES), checks

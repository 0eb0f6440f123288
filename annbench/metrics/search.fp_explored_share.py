"""Share of the records the hop loop explored in the window (its ``in`` and
``post`` rows; ``QueryStats.trace["explored"]``) that exact verification
found outside the filter (``fp_explored``): on the ``in`` route the false
positives of the approximate membership test (Bloom words, bucket codes)
that let them in."""


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    explored = sum(t.get("explored", 0) for t in tallies)
    if not explored:
        return None
    return sum(t.get("fp_explored", 0) for t in tallies) / explored

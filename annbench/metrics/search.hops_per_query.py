"""Mean hop-loop hops of the window's graph-routed queries (``in`` and
``post``; ``QueryStats.hops``)."""


def read(obs):
    hops = [int(h) for qs in obs.get("query_stats", [])
            for m, h in zip(qs.mechanism, qs.hops) if m != "pre"]
    if not hops:
        return None
    return sum(hops) / len(hops)

"""Share of the row-hops the hop loop dispatched in the window that were
still active: the sum of the graph-routed queries' hops
(``QueryStats.trace["row_hops_live"]``) over the rows dispatched, each
chunk's width times its hops (``row_hops_dispatched``)."""


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    dispatched = sum(t["row_hops_dispatched"] for t in tallies)
    if not dispatched:
        return None
    return sum(t["row_hops_live"] for t in tallies) / dispatched

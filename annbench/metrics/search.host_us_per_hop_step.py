"""Host microseconds per dispatched hop step in the window: the self
seconds of the program's ``search.hops`` span (a chunk of hops) and of its
four phase spans ``hop.*`` (``QueryStats.trace["host_s"]``; the disk
tier's own spans are not among them) over ``trace["hop_steps"]``."""

SPANS = ("search.hops", "hop.rerank", "hop.expand", "hop.select",
         "hop.settle")


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    steps = sum(t["hop_steps"] for t in tallies)
    if not steps:
        return None
    host = sum(t["host_s"].get(s, 0.0) for t in tallies for s in SPANS)
    return host * 1e6 / steps

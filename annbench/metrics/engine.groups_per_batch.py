"""(mechanism, pool bucket, config) groups per engine batch in the window
(``QueryStats.trace["groups"]``): the groups run their hop loops one
after another."""


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    if not tallies:
        return None
    return sum(t["groups"] for t in tallies) / len(tallies)

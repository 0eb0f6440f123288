"""Share of the window's queries that the engine's router sent down the
``pre`` route (``QueryStats.mechanism`` of every batch)."""


def read(obs):
    mech = [m for qs in obs.get("query_stats", []) for m in qs.mechanism]
    if not mech:
        return None
    return sum(m == "pre" for m in mech) / len(mech)

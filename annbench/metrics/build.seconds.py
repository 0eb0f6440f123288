"""Seconds of the index build in set-up, summed over its stages
(``FilteredANNEngine.build_times``)."""


def read(obs):
    t = obs.get("build_times")
    if not t:
        return None
    return sum(t.values())

"""Share of the traced part in which no operation ran on the device."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]

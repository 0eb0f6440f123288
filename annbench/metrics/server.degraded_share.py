"""Share of the window's completed requests that the server served at a
degrade rung (``ServerStats.degraded_served`` over ``completed``)."""


def read(obs):
    s = obs["server"]
    if not s["completed"]:
        return None
    return s["degraded_served"] / s["completed"]

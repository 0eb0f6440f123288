"""Requests answered per second in the traced run's window, by the same
arithmetic as the end-to-end ``qps`` (``stats.qps``): for the cells whose
window is host-bound and whose ``qps`` spreads too widely from run to run
to hold a bound, so that it is read here and not end to end."""


def read(obs):
    return obs.get("qps")

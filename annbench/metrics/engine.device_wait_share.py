"""Share of the engine batches' host seconds in the window that the host
spent blocked on the device: ``QueryStats.trace["device_wait_s"]`` (the
program's timed readbacks) over the self seconds of all its spans
(``trace["host_s"]``, which sum to the batch's time in ``execute``)."""


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    host = sum(sum(t["host_s"].values()) for t in tallies)
    if host <= 0:
        return None
    return sum(t["device_wait_s"] for t in tallies) / host

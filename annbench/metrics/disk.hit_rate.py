"""Page-cache hits over page lookups of the disk tier in the window
(``DiskRecordStore.delta``)."""


def read(obs):
    d = obs.get("disk")
    if d is None or not d["hits"] + d["misses"]:
        return None
    return d["hits"] / (d["hits"] + d["misses"])

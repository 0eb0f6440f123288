"""Host microseconds inside the disk tier's ``os.pread`` calls per page
they read in the window (``DiskRecordStore.delta``: ``pread_us`` over
``pages_read``; read-ahead included)."""


def read(obs):
    d = obs.get("disk")
    if d is None or d.get("pread_us") is None or not d["pages_read"]:
        return None
    return d["pread_us"] / d["pages_read"]

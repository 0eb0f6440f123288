"""Host microseconds of the disk tier's ``fetch`` per record it fetched in
the window (``DiskRecordStore.delta``: ``fetch_us`` over
``records_fetched``; page reads and read-ahead included)."""


def read(obs):
    d = obs.get("disk")
    if d is None or d.get("fetch_us") is None or not d["records_fetched"]:
        return None
    return d["fetch_us"] / d["records_fetched"]

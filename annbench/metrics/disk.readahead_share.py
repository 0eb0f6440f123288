"""Share of the pages the disk tier read in the window that read-ahead
read (``readahead_pages`` over ``pages_read``)."""


def read(obs):
    d = obs.get("disk")
    if d is None or not d["pages_read"]:
        return None
    return d["readahead_pages"] / d["pages_read"]

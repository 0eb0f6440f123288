"""Top-level PyTorch operator calls on the host per query in the traced
round: the calls the server's worker makes inside its flushes, over the
flushes' queries."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or not tr["flush_queries"]:
        return None
    return tr["flush_ops"] / tr["flush_queries"]

"""Hop steps the hop loop dispatched per engine batch in the window: the
sum of ``QueryStats.trace["hop_steps"]`` (``hop_chunk`` for each chunk the
pipelined search dispatched, whatever its width) over the batches."""


def read(obs):
    tallies = [t for t in (getattr(qs, "trace", None)
                           for qs in obs.get("query_stats", []))
               if t is not None]
    if not tallies:
        return None
    return sum(t["hop_steps"] for t in tallies) / len(tallies)

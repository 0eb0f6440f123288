"""The general traffic generator: a query pool and the clients that send it.

A traffic mix is a JSON file under ``traffic/`` (its name is the mix's
name). It holds parameters only:

- ``kind``: ``"closed"`` — each of ``clients`` clients submits its next
  request as soon as its last one has returned;
- ``pool``: the number of distinct queries, each a vector held out of the
  corpus and a filter, a whole number of rounds of ``clients``;
- the filters, in one of two spellings (a mix that gives both is refused):

  - ``filter_tags``: {number of tags: share of the pool}; the tags of a
    filter are distinct, each drawn by its popularity in the corpus, and
    ANDed;
  - ``filters``: a list of kinds of filter, each ``{"share": s, "tags": t,
    "range": <numeric field or null>, "range_share": [lo, hi]}``: t tags
    drawn as above, ANDed with, where ``range`` names a field, a half-open
    range ``[v_a, v_b)`` over it whose bounds are two values of the
    corpus's own sorted column, so that it holds b - a records (up to ties)
    and both bounds are exact float32 values; its share b - a ÷ N is drawn
    log-uniformly in ``range_share``;

- ``tag_share_max`` (optional): every drawn tag is one of the tags whose
  corpus share is at or under it, each still drawn by its popularity;
- ``request``: the ``SearchRequest`` fields every request carries (``k``,
  ``l``, ``policy``, ...).

The pool is made from the run's seed; the clients send its rows in a fixed
order (``ClientStreams``), so one seed gives the same work whatever the
timing, and every seed the same mix of filters.
"""
from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np

from annbench.corpus import Corpus, rng_for


class Pool:
    def __init__(self, vectors: np.ndarray, tags: np.ndarray,
                 ranges: np.ndarray, fields: tuple):
        self.vectors = vectors        # (P, dim) float32
        self.tags = tags              # (P, T) int32, -1 padded
        # (P, F, 2) float32 [lo, hi) of each field; (-inf, inf) where the
        # filter has no predicate on it
        self.ranges = ranges
        self.fields = tuple(fields)   # (F,) the corpus's numeric fields

    def __len__(self) -> int:
        return self.vectors.shape[0]


def open_ranges(rows: int, fields: int) -> np.ndarray:
    """(rows, fields, 2) float32 ranges that hold every value."""
    out = np.empty((rows, fields, 2), np.float32)
    out[..., 0], out[..., 1] = -np.inf, np.inf
    return out


def _strata(shares: dict, slots: int) -> list:
    """The kind of each of a round's slots: every run of slots holds each
    kind in its share, as near as whole slots allow (largest deficit first,
    ties to the smaller key)."""
    kinds = sorted(shares)
    got = dict.fromkeys(kinds, 0)
    out = []
    for i in range(slots):
        t = max(kinds, key=lambda t: ((i + 1) * shares[t] - got[t], -t))
        got[t] += 1
        out.append(t)
    return out


def _draw_filters(flat: np.ndarray, rng, rows: int, t: int) -> np.ndarray:
    """(rows, t) distinct tags a row, each drawn by its popularity: a
    uniform pick from ``flat``, every tag once for each record carrying
    it."""
    block = flat[rng.integers(0, flat.size, (rows, t))]
    # redraw tags that repeat one earlier in the same filter
    for j in range(1, t):
        while True:
            same = (block[:, j:j + 1] == block[:, :j]).any(1)
            if not same.any():
                break
            block[same, j] = flat[rng.integers(0, flat.size,
                                               int(same.sum()))]
    return block


def tag_draws(corpus: Corpus, share_max: float | None) -> np.ndarray:
    """The tag occurrences that filters draw from: all of the corpus's, or
    those of the tags whose corpus share is at or under ``share_max``."""
    if share_max is None:
        return corpus.tag_flat
    share = np.bincount(corpus.tag_flat, minlength=corpus.vocab) / corpus.n
    flat = corpus.tag_flat[share[corpus.tag_flat] <= float(share_max)]
    if not flat.size:
        raise ValueError(f"no tag has a corpus share at or under "
                         f"{share_max}")
    return flat


def draw_ranges(column: np.ndarray, rng, rows: int, share_lo: float,
                share_hi: float) -> tuple:
    """``rows`` half-open ranges over one numeric field. ``column`` is the
    field's values, sorted. Each range's target share is log-uniform in
    [share_lo, share_hi]; it spans that many records, rounded (at least
    one), from a uniform start, and its bounds are the column's values at
    its two ends (+inf past the last). Returns (bounds (rows, 2) float32,
    the share each holds, the target shares)."""
    n = column.size
    lo_l, hi_l = np.log(float(share_lo)), np.log(float(share_hi))
    target = np.exp(lo_l + (hi_l - lo_l) * rng.random(rows))
    count = np.clip(np.rint(target * n).astype(np.int64), 1, n)
    start = rng.integers(0, n - count + 1)
    lo = column[start]
    # past every value tied with lo, so no range is empty
    end = np.maximum(start + count, np.searchsorted(column, lo, "right"))
    hi = np.where(end < n, column[np.minimum(end, n - 1)], np.float32(np.inf))
    bounds = np.stack([lo, hi], axis=1).astype(np.float32)
    held = (np.searchsorted(column, bounds[:, 1], "left")
            - np.searchsorted(column, bounds[:, 0], "left")) / n
    return bounds, held, target


def _kinds(traffic: dict) -> dict:
    """{key: kind} of the mix's filters, in the file's order; a kind is
    {"share", "tags", "range", "range_share"}. ``filter_tags`` keys its
    kinds by their number of tags, ``filters`` by their place."""
    if ("filter_tags" in traffic) == ("filters" in traffic):
        raise ValueError("a traffic mix gives its filters as either "
                         "filter_tags or filters")
    if "filter_tags" in traffic:
        return {int(t): {"share": float(s), "tags": int(t), "range": None}
                for t, s in traffic["filter_tags"].items()}
    kinds = {}
    for i, k in enumerate(traffic["filters"]):
        kind = {"share": float(k["share"]), "tags": int(k.get("tags", 0)),
                "range": k.get("range")}
        if kind["range"] is not None:
            lo, hi = (float(v) for v in k["range_share"])
            if not 0 < lo <= hi <= 1:
                raise ValueError(f"range_share {k['range_share']} is not "
                                 "within (0, 1]")
            kind["range_share"] = (lo, hi)
        kinds[i] = kind
    return kinds


def make_pool(traffic: dict, corpus: Corpus, seed: int) -> Pool:
    """The pool, in rounds of ``clients`` rows. Every round holds each kind
    of filter in its share and, within a kind, one filter from each
    stratum of selectivity (the product of its tags' corpus shares and its
    range's share), so every round, and every seed, asks for the same mix
    of work in another order."""
    rng = rng_for(seed, "pool")
    size, clients = int(traffic["pool"]), int(traffic["clients"])
    if size % clients:
        raise ValueError(f"pool {size} is no whole number of rounds of "
                         f"{clients}")
    if corpus.held_out.shape[0] < size:
        raise ValueError(f"the corpus holds out {corpus.held_out.shape[0]} "
                         f"vectors, the pool needs {size}")
    rounds = size // clients
    kinds = _kinds(traffic)
    slot_kind = np.array(_strata({key: k["share"] for key, k in kinds.items()},
                                 clients))
    flat = tag_draws(corpus, traffic.get("tag_share_max"))
    share = np.bincount(corpus.tag_flat, minlength=corpus.vocab) / corpus.n
    fields = corpus.num_names
    tags = np.full((rounds, clients, max(k["tags"] for k in kinds.values())),
                   -1, np.int32)
    ranges = open_ranges(rounds * clients, len(fields)).reshape(
        rounds, clients, len(fields), 2)
    for key, kind in kinds.items():
        t = kind["tags"]
        slots = np.flatnonzero(slot_kind == key)
        block = _draw_filters(flat, rng, slots.size * rounds, t)
        sel = np.prod(share[block], axis=1)
        if kind["range"] is not None:
            if kind["range"] not in fields:
                raise ValueError(f"the corpus has no numeric field "
                                 f"{kind['range']!r} (it has {fields})")
            j = fields.index(kind["range"])
            bounds, held, _ = draw_ranges(
                np.sort(corpus.numerics[:, j]), rng, block.shape[0],
                *kind["range_share"])
            sel = sel * held
        # strata of selectivity (ties at random), one filter of each a
        # round, the rounds in a random order within each stratum
        order = np.lexsort((rng.random(sel.size), sel))
        strata = order.reshape(slots.size, rounds)
        strata = np.take_along_axis(
            strata, rng.random(strata.shape).argsort(axis=1), axis=1)
        tags[:, slots, :t] = block[strata.T]
        if kind["range"] is not None:
            ranges[:, slots, j] = bounds[strata.T]
    return Pool(corpus.held_out[:size], tags.reshape(size, -1),
                ranges.reshape(size, len(fields), 2), fields)


class ClientStreams:
    """The pool rows each client sends: the clients' j-th requests are the
    round of ``clients`` rows after ``start + j * clients``, and the window
    sweeps the pool without repeating a row before it has sent them
    all."""

    def __init__(self, clients: int, pool: int, start: int = 0):
        self._clients, self._pool, self._start = clients, pool, start
        self._sent = [0] * clients

    def next(self, client: int) -> int:
        j = self._sent[client]
        self._sent[client] += 1
        return (self._start + j * self._clients + client) % self._pool


def closed_loop(submit: Callable, clients: int, streams: ClientStreams,
                close: float | None = None, total: int | None = None,
                marks: tuple = (), drain_s: float = 60.0,
                clock=time.perf_counter) -> list:
    """Drive ``clients`` closed-loop clients through ``submit(pool_index)``
    (which returns a handle with ``done`` and ``result(timeout=)``) until
    the clock passes ``close`` or ``total`` requests were submitted. Then
    wait for the requests still out, giving them up once none has come back
    for ``drain_s`` (at any time: a request that never comes back stalls
    its client, and the loop ends when every client is stalled).

    ``marks`` holds (count, callable) pairs, each called once from this
    thread when ``count`` requests have come back, before any client sends
    again (the callables left are called at the end). Returns one record
    per request:
    client, pool index, submit and completion times (``t_done`` None for a
    request that never came back), and the result or the error.
    """
    records: list = []
    out: collections.deque = collections.deque()
    pending = sorted(marks, key=lambda m: m[0])
    sent = back = 0

    def open_more() -> bool:
        return (close is None or clock() < close) and (
            total is None or sent < total)

    def send(client: int) -> None:
        nonlocal sent
        idx = streams.next(client)
        rec = {"client": client, "pool": idx, "t_submit": clock(),
               "t_done": None, "result": None, "error": None}
        records.append(rec)
        sent += 1
        try:
            out.append((rec, submit(idx)))
        except Exception as e:          # refused at admission
            rec["error"] = e
            rec["t_done"] = clock()

    for c in range(clients):
        if open_more():
            send(c)
    # the requests out are given up once none has come back for drain_s
    last = clock()
    closed = False
    while out:
        now = clock()
        if not closed and not open_more():
            closed, last = True, now
        if now - last >= drain_s:
            break
        timeout = min(t for t in (close, last + drain_s)
                      if t is not None and t > now) - now
        done, still = [], collections.deque()
        for item in out:
            (done if item[1].done else still).append(item)
        if not done:
            try:
                still[0][1].result(timeout=timeout)
            except Exception:
                pass        # a timeout, or an error recorded below
            continue
        out = still
        now = last = clock()
        for rec, handle in done:
            rec["t_done"] = now
            try:
                rec["result"] = handle.result(timeout=0)
            except Exception as e:
                rec["error"] = e
        back += len(done)
        while pending and pending[0][0] <= back:
            pending.pop(0)[1]()
        for rec, _ in done:
            if open_more():
                send(rec["client"])
    while pending:
        pending.pop(0)[1]()
    return records

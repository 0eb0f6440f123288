"""The general traffic generator: a query pool and the clients that send it.

A traffic mix is a JSON file under ``traffic/`` (its name is the mix's
name). It holds parameters only:

- ``kind``: ``"closed"`` — each of ``clients`` clients submits its next
  request as soon as its last one has returned;
- ``pool``: the number of distinct queries, each a vector held out of the
  corpus and a filter, a whole number of rounds of ``clients``;
- ``filter_tags``: {number of tags: share of the pool}; the tags of a
  filter are distinct, each drawn by its popularity in the corpus, and
  ANDed;
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
    def __init__(self, vectors: np.ndarray, tags: np.ndarray):
        self.vectors = vectors        # (P, dim) float32
        self.tags = tags              # (P, T) int32, -1 padded

    def __len__(self) -> int:
        return self.vectors.shape[0]


def _strata(shares: dict, slots: int) -> list:
    """The number of tags of each of a round's slots: every run of slots
    holds each kind in its share, as near as whole slots allow (largest
    deficit first)."""
    kinds = sorted(shares)
    got = dict.fromkeys(kinds, 0)
    out = []
    for i in range(slots):
        t = max(kinds, key=lambda t: ((i + 1) * shares[t] - got[t], -t))
        got[t] += 1
        out.append(t)
    return out


def _draw_filters(corpus: Corpus, rng, rows: int, t: int) -> np.ndarray:
    """(rows, t) distinct tags a row, each drawn by its corpus popularity."""
    block = corpus.tag_flat[rng.integers(0, corpus.tag_flat.size, (rows, t))]
    # redraw tags that repeat one earlier in the same filter
    for j in range(1, t):
        while True:
            same = (block[:, j:j + 1] == block[:, :j]).any(1)
            if not same.any():
                break
            block[same, j] = corpus.tag_flat[rng.integers(
                0, corpus.tag_flat.size, int(same.sum()))]
    return block


def make_pool(traffic: dict, corpus: Corpus, seed: int) -> Pool:
    """The pool, in rounds of ``clients`` rows. Every round holds each kind
    of filter in its share and, within a kind, one filter from each
    stratum of selectivity (the product of its tags' corpus shares), so
    every round, and every seed, asks for the same mix of work in another
    order."""
    rng = rng_for(seed, "pool")
    size, clients = int(traffic["pool"]), int(traffic["clients"])
    if size % clients:
        raise ValueError(f"pool {size} is no whole number of rounds of "
                         f"{clients}")
    if corpus.held_out.shape[0] < size:
        raise ValueError(f"the corpus holds out {corpus.held_out.shape[0]} "
                         f"vectors, the pool needs {size}")
    rounds = size // clients
    shares = {int(t): float(s) for t, s in traffic["filter_tags"].items()}
    kinds = np.array(_strata(shares, clients))
    share = np.bincount(corpus.tag_flat, minlength=corpus.vocab) / corpus.n
    tags = np.full((rounds, clients, max(shares)), -1, np.int32)
    for t in shares:
        slots = np.flatnonzero(kinds == t)
        block = _draw_filters(corpus, rng, slots.size * rounds, t)
        sel = np.prod(share[block], axis=1)
        # strata of selectivity (ties at random), one filter of each a
        # round, the rounds in a random order within each stratum
        order = np.lexsort((rng.random(sel.size), sel))
        strata = order.reshape(slots.size, rounds)
        strata = np.take_along_axis(
            strata, rng.random(strata.shape).argsort(axis=1), axis=1)
        tags[:, slots, :t] = block[strata.T]
    return Pool(corpus.held_out[:size], tags.reshape(size, -1))


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

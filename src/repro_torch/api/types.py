"""Typed request/result surface of the unified query layer.

``SearchRequest`` carries one query vector plus optional per-request
overrides of the index-level search defaults; ``SearchResult`` replaces
the engine's positional ``(ids, dists, QueryStats)`` tuple with ids,
distances, resolved record metadata, and the per-query slice of the
execution statistics.

Counterpart of ``repro.api.types``, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


class ServeError(RuntimeError):
    """Base of the serving tier's admission errors (serve/server.py)."""


class Overloaded(ServeError):
    """Rejected with backpressure: the bounded admission queue is full.

    ``retry_after_s`` is the server's predicted drain time for the
    current backlog — a usable client backoff hint."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServeError):
    """Shed: the request's ``deadline_us`` cannot (or did not) hold —
    predicted completion past the deadline at admission, or the deadline
    expired while queued."""


@dataclasses.dataclass
class SearchRequest:
    """One filtered top-k query.

    ``filter`` may be a DSL expression (the ``repro_torch.api.Tag``/``Num``
    algebra), a raw engine ``Selector`` (escape hatch), or None for unfiltered
    search. Unset overrides inherit the index defaults.

    ``deadline_us`` is a *serving* attribute, not a search override: a
    relative completion budget (µs from submission) that the admission
    controller enforces (serve/server.py). ``None`` — the default — opts
    out of deadline handling entirely; such requests execute bit-identically
    to the pre-serving path.
    """
    query: np.ndarray
    filter: object = None
    k: Optional[int] = None
    l: Optional[int] = None
    policy: Optional[str] = None
    max_hops: Optional[int] = None
    beam_width: Optional[int] = None
    prefetch_depth: Optional[int] = None
    deadline_us: Optional[float] = None

    def overrides(self) -> dict:
        # deadline_us deliberately excluded: it shapes admission and
        # scheduling, never the resolved SearchConfig
        out = {}
        for f in ("k", "l", "policy", "max_hops", "beam_width",
                  "prefetch_depth"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-query slice of the engine's batched QueryStats."""
    mechanism: str
    io_pages: int
    est_io_pages: float
    dist_comps: int
    est_compute: float
    hops: int
    explored: int
    fp_explored: int
    n_valid: int
    selectivity: float
    precision_in: float
    faults: int = 0           # injected fault events (0 without a plan)
    retries: int = 0          # extra read attempts issued by the ladder
    degraded: int = 0         # rows answered from the in-memory fallback

    @classmethod
    def from_query_stats(cls, stats, i: int) -> "RequestStats":
        return cls(
            mechanism=stats.mechanism[i],
            io_pages=int(stats.io_pages[i]),
            est_io_pages=float(stats.est_io_pages[i]),
            dist_comps=int(stats.dist_comps[i]),
            est_compute=float(stats.est_compute[i]),
            hops=int(stats.hops[i]),
            explored=int(stats.explored[i]),
            fp_explored=int(stats.fp_explored[i]),
            n_valid=int(stats.n_valid[i]),
            selectivity=float(stats.selectivity[i]),
            precision_in=float(stats.precision_in[i]),
            faults=int(stats.faults[i]),
            retries=int(stats.retries[i]),
            degraded=int(stats.degraded[i]),
        )


@dataclasses.dataclass
class SearchResult:
    """Verified-valid top-k for one request. ``ids`` is (k,) int32 padded
    with -1; ``metadata[i]`` is the resolved record dict (None for pads)."""
    ids: np.ndarray
    dists: np.ndarray
    metadata: list
    stats: RequestStats

    @property
    def matches(self) -> Sequence[tuple]:
        """(id, dist, metadata) triples for the non-pad results."""
        return [(int(i), float(d), m)
                for i, d, m in zip(self.ids, self.dists, self.metadata)
                if i >= 0]

    def __len__(self) -> int:
        return int(np.sum(self.ids >= 0))

"""Synthetic filtered-ANNS datasets mirroring the paper's workload shapes.

Vectors: Gaussian mixture (clustered, like real embeddings).
Labels:  Zipf-distributed categorical labels (YFCC/LAION-style head/tail).
Values:  lognormal numeric attribute (LAION image-width analogue).

Workload generators produce (query vector, Selector) pairs for the paper's
five workloads: Label, LabelAnd, LabelOr, Range, Hybrid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.selectors import (AndSelector, LabelAndSelector,
                                  LabelOrSelector, OrSelector, RangeSelector,
                                  Selector)


@dataclasses.dataclass
class SynthFilteredDataset:
    vectors: np.ndarray          # (N, D) float32
    label_offsets: np.ndarray    # (N+1,) int64
    label_flat: np.ndarray       # (nnz,) int32
    n_labels: int
    values: np.ndarray           # (N,) float32
    queries: np.ndarray          # (Q, D) float32
    query_labels: list           # per query: list[int]
    query_ranges: np.ndarray     # (Q, 2) float32

    def metadata(self, tag_field: str = "label",
                 num_field: str = "value") -> list[dict]:
        """Per-record metadata dicts for the ``Index.build`` facade.

        NOTE: Index.build renumbers tags by first appearance — resolve
        query labels through ``index.label_id(tag_field, value)`` (as
        ``make_selectors`` does), never by raw dataset label id.
        """
        return [
            {tag_field: self.label_flat[s:e].tolist(), num_field: float(v)}
            for s, e, v in zip(self.label_offsets[:-1],
                               self.label_offsets[1:], self.values)
        ]


def make_filtered_dataset(n: int = 20000, d: int = 48, n_queries: int = 64,
                          n_labels: int = 200, avg_labels: float = 4.0,
                          n_clusters: int = 32, zipf_a: float = 1.3,
                          seed: int = 0) -> SynthFilteredDataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, (n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    vectors = (centers[assign]
               + rng.normal(0, 0.35, (n, d))).astype(np.float32)

    # Zipf labels: label popularity ~ 1/rank^a
    ranks = np.arange(1, n_labels + 1, dtype=np.float64)
    popularity = 1.0 / ranks ** zipf_a
    popularity /= popularity.sum()
    counts = rng.poisson(avg_labels, n).clip(1, 16)
    flat = []
    for c in counts:
        flat.append(rng.choice(n_labels, size=c, replace=True, p=popularity))
    label_flat = np.concatenate(flat).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    values = rng.lognormal(6.0, 0.8, n).astype(np.float32)

    qassign = rng.integers(0, n_clusters, n_queries)
    queries = (centers[qassign]
               + rng.normal(0, 0.35, (n_queries, d))).astype(np.float32)
    # query labels drawn from the same popularity law (1-3 each)
    query_labels = []
    for _ in range(n_queries):
        qc = int(rng.integers(1, 4))
        query_labels.append(sorted(set(
            int(x) for x in rng.choice(n_labels, qc, replace=True,
                                       p=popularity))))
    # query ranges spanning selectivities from ~0.1% to ~50%
    q = np.sort(values)
    ranges = np.zeros((n_queries, 2), np.float32)
    for i in range(n_queries):
        frac = float(10 ** rng.uniform(-3, np.log10(0.5)))
        lo_idx = int(rng.uniform(0, max(1, (1 - frac))) * n)
        hi_idx = min(n - 1, lo_idx + max(1, int(frac * n)))
        ranges[i] = (q[lo_idx], q[hi_idx])
    return SynthFilteredDataset(vectors, offsets, label_flat, n_labels,
                                values, queries, query_labels, ranges)


def _resolve_labels(engine, labels, tag_field: str) -> tuple[list[int], bool]:
    """Map dataset label values to engine label ids.

    The ``Index`` facade renumbers tags by vocabulary first-appearance
    order, so dataset ids must go through ``engine.label_id``; raw
    engines use dataset ids verbatim. Returns (ids, any_unseen) — unseen
    labels (zero corpus occurrences) have no vocabulary entry and are
    dropped from the id list."""
    mapper = getattr(engine, "label_id", None)
    if mapper is None:
        return [int(l) for l in labels], False
    ids = [mapper(tag_field, int(l)) for l in labels]
    return [i for i in ids if i is not None], any(i is None for i in ids)


def make_selectors(ds: SynthFilteredDataset, engine, workload: str,
                   n_queries: int | None = None,
                   tag_field: str = "label") -> list[Selector]:
    """Build per-query Selector objects for one of the paper's workloads."""
    ls, rs = engine.label_store, engine.range_store
    nq = n_queries or ds.queries.shape[0]
    sels: list[Selector] = []
    for i in range(nq):
        labels = ds.query_labels[i]
        lo, hi = float(ds.query_ranges[i, 0]), float(ds.query_ranges[i, 1])
        if workload == "label":            # single label (paper Fig. 7)
            ids, _ = _resolve_labels(engine, labels[:1], tag_field)
            sels.append(LabelOrSelector(ls, ids))
        elif workload == "label_and":
            ids, unseen = _resolve_labels(engine, labels, tag_field)
            # AND with an unseen label matches nothing: empty-OR selector
            sels.append(LabelOrSelector(ls, []) if unseen
                        else LabelAndSelector(ls, ids))
        elif workload == "label_or":
            ids, _ = _resolve_labels(engine, labels, tag_field)
            sels.append(LabelOrSelector(ls, ids))
        elif workload == "range":
            sels.append(RangeSelector(rs, lo, hi))
        elif workload == "hybrid":         # LabelOr OR Range (paper §5.1)
            ids, _ = _resolve_labels(engine, labels, tag_field)
            sels.append(OrSelector([LabelOrSelector(ls, ids),
                                    RangeSelector(rs, lo, hi)]))
        elif workload == "label_and_range":
            ids, unseen = _resolve_labels(engine, labels[:2], tag_field)
            lab = LabelOrSelector(ls, []) if unseen \
                else LabelAndSelector(ls, ids)
            sels.append(AndSelector([lab, RangeSelector(rs, lo, hi)]))
        else:
            raise ValueError(workload)
    return sels


def make_sliding_range_selectors(engine, selectivity: float,
                                 n_queries: int, field: int = 0) -> list:
    """Per-query range filters of one controlled selectivity, sliding the
    window across the value distribution so queries don't share a filter
    — the mid-selectivity workload shape of the paper's Fig. 2 sweeps.
    Shared by benchmarks/bench_search.py and the search A/B parity suite
    (one definition, so both measure the same workload)."""
    values = np.sort(np.asarray(engine.range_store.field_store(field).values))
    n = values.size
    width = max(1, int(round(selectivity * n)))
    out = []
    for i in range(n_queries):
        lo_i = int((n - width) * (i / max(1, n_queries - 1)))
        lo = float(values[lo_i])
        hi = float(values[min(lo_i + width, n - 1)]) + 1e-3
        out.append(RangeSelector(engine.range_store, lo, hi, field=field))
    return out

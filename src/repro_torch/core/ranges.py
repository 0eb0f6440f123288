"""Range attribute store: on-"SSD" sorted index + in-memory quantized summaries.

Layout (paper §4.3.2), per numeric field:
  - on-SSD: flat array of <vector_id, value> pairs sorted by value; a range
    query scans one contiguous chunk (sequential reads, counted in pages);
  - in-memory: (a) 1-byte bucket code per vector against 256 global quantile
    bucket boundaries (drives is_member_approx), (b) a 1000-quantile summary
    for selectivity estimation.

``RangeStore`` holds one field; ``MultiRangeStore`` stacks F of them behind
an ``(n, F)`` value matrix so a query may carry predicates over several
numeric fields at once (the schema-first attribute surface). Engines always
hold a ``MultiRangeStore`` — single-field indexes are the F=1 special case.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.io_sim import PAGE_BYTES

N_BUCKETS = 256
N_QUANTILES = 1000
REFRESH_FRAC = 0.25   # re-derive bucket bounds once un-refreshed inserts
                      # exceed this fraction of the store


def _quantile_bounds(values: np.ndarray) -> np.ndarray:
    """Strictly-increasing global bucket boundaries from value quantiles."""
    qs = np.quantile(values, np.linspace(0.0, 1.0, N_BUCKETS + 1)) \
        if values.size else np.zeros(N_BUCKETS + 1)
    qs = np.maximum.accumulate(qs)
    bounds = qs.astype(np.float32)
    bounds[0] = -np.inf if values.size == 0 \
        else np.nextafter(bounds[0], -np.inf)
    return bounds


def _bucket_codes(values: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    return np.clip(np.searchsorted(bounds, values, side="right") - 1,
                   0, N_BUCKETS - 1).astype(np.uint8)


@dataclasses.dataclass
class RangeStore:
    n_vectors: int
    values: np.ndarray           # (N,) float32 — row-wise copy (in records)
    # on-SSD sorted index
    sorted_values: np.ndarray    # (N,) float32
    sorted_ids: np.ndarray       # (N,) int32
    # in-memory summaries
    bucket_bounds: np.ndarray    # (N_BUCKETS+1,) float32 — global boundaries
    bucket_codes: np.ndarray     # (N,) uint8 — per-vector 1-byte code
    quantiles: np.ndarray        # (N_QUANTILES,) float32 — for selectivity
    # staleness tracking for skewed insert streams (not checkpointed:
    # the saved bounds are whatever the last refresh produced, and the
    # counter restarts — a loaded index is treated as freshly bucketed)
    inserted_since_refresh: int = 0
    bounds_refreshed: bool = False   # did the LAST append re-bucket?

    def selectivity(self, lo: float, hi: float) -> float:
        """Estimated fraction of vectors with value in [lo, hi)."""
        q = self.quantiles
        f_lo = np.searchsorted(q, lo, side="left") / q.size
        f_hi = np.searchsorted(q, hi, side="left") / q.size
        return float(max(0.0, f_hi - f_lo))

    def precision(self, lo: float, hi: float) -> float:
        """Estimated precision of the bucket-code is_member_approx (paper:
        true positives from quantiles ÷ positives from coarse buckets)."""
        true_pos = self.selectivity(lo, hi)
        blo, bhi = self.bucket_range(lo, hi)
        # fraction of vectors in overlapping coarse buckets, from quantiles
        cov_lo = float(self.bucket_bounds[blo])
        cov_hi = float(self.bucket_bounds[min(bhi + 1, N_BUCKETS)])
        total_pos = self.selectivity(cov_lo, np.nextafter(cov_hi, np.inf))
        return float(true_pos / max(total_pos, 1e-12))

    def bucket_range(self, lo: float, hi: float) -> tuple[int, int]:
        """Inclusive coarse-bucket id range overlapping [lo, hi)."""
        blo = int(np.clip(np.searchsorted(self.bucket_bounds, lo, side="right") - 1,
                          0, N_BUCKETS - 1))
        bhi = int(np.clip(np.searchsorted(self.bucket_bounds, hi, side="left") - 1,
                          0, N_BUCKETS - 1))
        return blo, max(blo, bhi)

    def scan(self, lo: float, hi: float) -> tuple[np.ndarray, int]:
        """Exact on-SSD scan: valid ids + pages read (sequential)."""
        s = int(np.searchsorted(self.sorted_values, lo, side="left"))
        e = int(np.searchsorted(self.sorted_values, hi, side="left"))
        pages = max(1, -(-max(e - s, 0) * 8 // PAGE_BYTES))
        return self.sorted_ids[s:e], pages

    def memory_bytes(self) -> dict:
        return {
            "bucket_codes_bytes": int(self.bucket_codes.nbytes),
            "bounds_bytes": int(self.bucket_bounds.nbytes + self.quantiles.nbytes),
            "ssd_sorted_index_bytes": int(self.sorted_values.nbytes
                                          + self.sorted_ids.nbytes),
        }


    def append(self, new_values: np.ndarray) -> "RangeStore":
        """Incremental insert-path extension (no re-sort; re-bucket only
        when stale).

        New <id, value> pairs merge into the sorted index at their
        searchsorted positions (one vectorized memcpy instead of an
        O(N log N) rebuild); bucket boundaries normally stay *fixed* so
        new codes remain comparable with existing ones — the
        no-false-negative contract of ``is_member_approx`` is anchored to
        one shared set of bounds. Quantiles are re-read from the merged
        sorted array (O(N_QUANTILES) indexing), so selectivity estimates
        track inserts.

        **Staleness guard (skewed streams):** once the rows inserted
        since the last refresh exceed ``REFRESH_FRAC`` of the store, the
        bounds no longer describe the distribution (e.g. a stream of
        values above the build-time max piles every new row into bucket
        255, collapsing ``is_member_approx`` precision over the new
        region). The append then re-derives the global bounds from the
        merged values and re-codes *every* row against them — bounds and
        codes move together, so the no-false-negative contract is
        preserved. ``bounds_refreshed`` flags the returned store so the
        engine re-uploads the full in-memory code column (a row-tail
        write would leave device codes inconsistent with the new bounds).
        """
        new_values = np.asarray(new_values, np.float32)
        m = new_values.size
        if m == 0:
            return self
        new_ids = np.arange(self.n_vectors, self.n_vectors + m, dtype=np.int32)
        order = np.argsort(new_values, kind="stable")
        sv, si = new_values[order], new_ids[order]
        pos = np.searchsorted(self.sorted_values, sv, side="left")
        sorted_values = np.insert(self.sorted_values, pos, sv)
        sorted_ids = np.insert(self.sorted_ids, pos, si)
        n = self.n_vectors + m
        values = np.concatenate([self.values, new_values])
        quantiles = sorted_values[
            np.minimum((np.linspace(0.0, 1.0, N_QUANTILES) * (n - 1))
                       .round().astype(np.int64), n - 1)]
        inserted = self.inserted_since_refresh + m
        if inserted > REFRESH_FRAC * n:
            bounds = _quantile_bounds(values)
            return RangeStore(
                n_vectors=n, values=values,
                sorted_values=sorted_values, sorted_ids=sorted_ids,
                bucket_bounds=bounds,
                bucket_codes=_bucket_codes(values, bounds),
                quantiles=quantiles,
                inserted_since_refresh=0, bounds_refreshed=True)
        new_codes = _bucket_codes(new_values, self.bucket_bounds)
        return RangeStore(
            n_vectors=n, values=values,
            sorted_values=sorted_values, sorted_ids=sorted_ids,
            bucket_bounds=self.bucket_bounds,
            bucket_codes=np.concatenate([self.bucket_codes, new_codes]),
            quantiles=quantiles,
            inserted_since_refresh=inserted, bounds_refreshed=False)


def build_range_store(values: np.ndarray) -> RangeStore:
    values = np.asarray(values, dtype=np.float32)
    n = values.size
    order = np.argsort(values, kind="stable")
    sorted_values = values[order]
    sorted_ids = order.astype(np.int32)

    # strictly increasing boundaries (dedupe plateaus)
    bucket_bounds = _quantile_bounds(values)
    codes = _bucket_codes(values, bucket_bounds)
    quantiles = np.quantile(values, np.linspace(0.0, 1.0, N_QUANTILES)) \
        .astype(np.float32)
    return RangeStore(n_vectors=n, values=values,
                      sorted_values=sorted_values, sorted_ids=sorted_ids,
                      bucket_bounds=bucket_bounds, bucket_codes=codes,
                      quantiles=quantiles)


@dataclasses.dataclass
class MultiRangeStore:
    """F numeric attribute fields behind one (n, F) matrix.

    Field identity is positional (the schema layer owns names); every
    per-field structure — sorted index, bucket bounds/codes, quantiles —
    lives in the wrapped per-field :class:`RangeStore`. The stacked
    ``values`` / ``bucket_codes`` matrices feed the record store and the
    in-memory device tier respectively.
    """
    stores: list            # F per-field RangeStore objects (F >= 1)

    @property
    def n_fields(self) -> int:
        return len(self.stores)

    @property
    def n_vectors(self) -> int:
        return self.stores[0].n_vectors

    @property
    def values(self) -> np.ndarray:
        """(n, F) float32 row-wise value matrix (record-store layout)."""
        return np.stack([s.values for s in self.stores], axis=1)

    @property
    def bucket_codes(self) -> np.ndarray:
        """(n, F) uint8 per-field 1-byte codes (in-memory tier layout)."""
        return np.stack([s.bucket_codes for s in self.stores], axis=1)

    def field_store(self, field: int) -> RangeStore:
        return self.stores[field]

    @property
    def bounds_refreshed(self) -> bool:
        """True when the last append re-bucketed any field — the engine
        must then re-upload the full device code matrix, not just the
        appended rows."""
        return any(s.bounds_refreshed for s in self.stores)

    def selectivity(self, lo: float, hi: float, field: int = 0) -> float:
        return self.stores[field].selectivity(lo, hi)

    def scan(self, lo: float, hi: float,
             field: int = 0) -> tuple[np.ndarray, int]:
        return self.stores[field].scan(lo, hi)

    def append(self, new_values: np.ndarray) -> "MultiRangeStore":
        """Incremental insert-path extension over all fields; ``new_values``
        is (m, F) (or (m,) for F=1)."""
        new_values = np.asarray(new_values, np.float32)
        if new_values.ndim == 1:
            new_values = new_values[:, None]
        assert new_values.shape[1] == self.n_fields
        return MultiRangeStore(
            [s.append(new_values[:, j]) for j, s in enumerate(self.stores)])

    def memory_bytes(self) -> dict:
        out: dict = {}
        for s in self.stores:
            for k, v in s.memory_bytes().items():
                out[k] = out.get(k, 0) + v
        return out


def build_multi_range_store(values: np.ndarray) -> MultiRangeStore:
    """(n, F) or (n,) value matrix -> per-field stores (F >= 1 enforced so
    device shapes stay uniform even for indexes with no numeric field)."""
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[:, None]
    if values.shape[1] == 0:
        values = np.zeros((values.shape[0], 1), np.float32)
    return MultiRangeStore(
        [build_range_store(values[:, j]) for j in range(values.shape[1])])

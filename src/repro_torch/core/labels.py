"""Label attribute store: CSR per-vector labels + on-"SSD" inverted indexes.

Layout (paper §4.3.1):
  - on-SSD: one posting list per label (vector IDs ascending, contiguous)
    -> scanned by pre_filter_approx, I/O counted in 4 KB pages;
  - in-memory: per-label offsets + counts (selectivity estimation) and the
    per-vector Bloom words (bloom.py).

Vectors additionally carry a row-wise copy of their labels inside the record
store (records.py) for exact verification — the paper's duplicated layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bloom
from repro_torch.core.io_sim import PAGE_BYTES


@dataclasses.dataclass
class LabelStore:
    n_vectors: int
    n_labels: int
    # CSR over vectors (row-wise copy; "in the records")
    vec_offsets: np.ndarray        # (N+1,) int64
    vec_labels: np.ndarray         # (nnz,) int32
    # CSR over labels (inverted index; "on SSD")
    inv_offsets: np.ndarray        # (n_labels+1,) int64
    inv_postings: np.ndarray       # (nnz,) int32 vector ids, ascending per label
    # in-memory summaries
    label_counts: np.ndarray       # (n_labels,) int64
    blooms: np.ndarray             # (N,) uint32
    k_hashes: int = 2

    @property
    def avg_labels_per_vec(self) -> float:
        return float(self.vec_labels.size) / max(1, self.n_vectors)

    def selectivity(self, label: int) -> float:
        return float(self.label_counts[label]) / max(1, self.n_vectors)

    def posting_pages(self, label: int, page_bytes: int = PAGE_BYTES) -> int:
        """Pages read to scan one label's posting list from SSD."""
        nbytes = int(self.label_counts[label]) * 4
        return max(1, -(-nbytes // page_bytes))

    def postings(self, label: int) -> np.ndarray:
        s, e = int(self.inv_offsets[label]), int(self.inv_offsets[label + 1])
        return self.inv_postings[s:e]

    def labels_of(self, vec_id: int) -> np.ndarray:
        s, e = int(self.vec_offsets[vec_id]), int(self.vec_offsets[vec_id + 1])
        return self.vec_labels[s:e]

    def memory_bytes(self) -> dict:
        """Table-3 style accounting: in-memory filter size vs on-SSD index."""
        return {
            "bloom_bytes": int(self.blooms.nbytes),
            "counts_bytes": int(self.label_counts.nbytes + self.inv_offsets.nbytes),
            "ssd_inverted_index_bytes": int(self.inv_postings.nbytes),
        }


def build_label_store(vec_offsets: np.ndarray, vec_labels: np.ndarray,
                      n_labels: int, k_hashes: int = 2) -> LabelStore:
    n = vec_offsets.size - 1
    vec_offsets = vec_offsets.astype(np.int64)
    vec_labels = vec_labels.astype(np.int32)

    # dedupe (vector, label) pairs: repeated labels would inflate posting
    # lists and push selectivity estimates past 1.0
    vec_ids0 = np.repeat(np.arange(n, dtype=np.int64), np.diff(vec_offsets))
    pair = vec_ids0 * (n_labels + 1) + vec_labels
    keep = np.zeros(pair.size, bool)
    uniq_idx = np.unique(pair, return_index=True)[1]
    keep[uniq_idx] = True
    if not keep.all():
        vec_labels = vec_labels[keep]
        counts = np.bincount(vec_ids0[keep], minlength=n)
        vec_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=vec_offsets[1:])

    # invert: sort (label, vec) pairs by label then vec id
    vec_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(vec_offsets))
    order = np.lexsort((vec_ids, vec_labels))
    inv_postings = vec_ids[order]
    sorted_labels = vec_labels[order]
    label_counts = np.bincount(sorted_labels, minlength=n_labels).astype(np.int64)
    inv_offsets = np.zeros(n_labels + 1, dtype=np.int64)
    np.cumsum(label_counts, out=inv_offsets[1:])

    blooms = bloom.build_blooms(vec_offsets, vec_labels, n, k_hashes)
    return LabelStore(
        n_vectors=n, n_labels=n_labels,
        vec_offsets=vec_offsets, vec_labels=vec_labels,
        inv_offsets=inv_offsets, inv_postings=inv_postings,
        label_counts=label_counts, blooms=blooms, k_hashes=k_hashes,
    )


def padded_vec_labels(store: LabelStore, max_labels: int,
                      pad_value: int = -1) -> np.ndarray:
    """Dense (N, max_labels) int32 copy for the record store (exact verify)."""
    return padded_rows_from_csr(store.vec_offsets, store.vec_labels,
                                max_labels, pad_value)


def padded_rows_from_csr(offsets: np.ndarray, flat: np.ndarray,
                         max_labels: int, pad_value: int = -1) -> np.ndarray:
    """CSR labels -> dense (rows, max_labels) int32 (insert-path slices)."""
    n = offsets.size - 1
    out = np.full((n, max_labels), pad_value, dtype=np.int32)
    counts = np.diff(offsets)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(flat.size) - np.repeat(offsets[:-1], counts)
    keep = pos < max_labels
    out[rows[keep], pos[keep]] = flat[keep]
    return out


def extend_label_store(store: LabelStore, new_offsets: np.ndarray,
                       new_flat: np.ndarray, n_labels: int) -> LabelStore:
    """Append a batch of vectors' labels without rebuilding the store.

    Inserted vector ids are all larger than existing ones, so each label's
    new postings land at the *end* of its run — one vectorized ``np.insert``
    merge instead of the build path's global lexsort; Bloom words are
    computed for the new rows only. ``n_labels`` may exceed the store's
    (vocabulary growth): new labels get empty runs extended in place.
    """
    new_offsets = np.asarray(new_offsets, np.int64)
    new_flat = np.asarray(new_flat, np.int32)
    m = new_offsets.size - 1
    n0 = store.n_vectors
    n_labels = max(store.n_labels, int(n_labels))

    # dedupe (vector, label) pairs within the batch (same rule as the build)
    vec_ids0 = np.repeat(np.arange(m, dtype=np.int64), np.diff(new_offsets))
    pair = vec_ids0 * (n_labels + 1) + new_flat
    keep = np.zeros(pair.size, bool)
    keep[np.unique(pair, return_index=True)[1]] = True
    if not keep.all():
        new_flat = new_flat[keep]
        counts = np.bincount(vec_ids0[keep], minlength=m)
        new_offsets = np.zeros(m + 1, np.int64)
        np.cumsum(counts, out=new_offsets[1:])

    vec_offsets = np.concatenate(
        [store.vec_offsets, store.vec_offsets[-1] + new_offsets[1:]])
    vec_labels = np.concatenate([store.vec_labels, new_flat])

    # inverted index: merge sorted-new-pairs at each label's old run end
    old_inv_off = store.inv_offsets
    if old_inv_off.size < n_labels + 1:
        old_inv_off = np.concatenate(
            [old_inv_off, np.full(n_labels + 1 - old_inv_off.size,
                                  old_inv_off[-1], np.int64)])
    vec_ids = np.repeat(np.arange(n0, n0 + m, dtype=np.int32),
                        np.diff(new_offsets))
    order = np.lexsort((vec_ids, new_flat))
    add_post, add_lab = vec_ids[order], new_flat[order]
    inv_postings = np.insert(store.inv_postings, old_inv_off[add_lab + 1],
                             add_post)
    label_counts = np.zeros(n_labels, np.int64)
    label_counts[:store.n_labels] = store.label_counts
    label_counts += np.bincount(add_lab, minlength=n_labels).astype(np.int64)
    inv_offsets = np.zeros(n_labels + 1, np.int64)
    np.cumsum(label_counts, out=inv_offsets[1:])

    blooms = np.concatenate(
        [store.blooms,
         bloom.build_blooms(new_offsets, new_flat, m, store.k_hashes)])
    return LabelStore(
        n_vectors=n0 + m, n_labels=n_labels,
        vec_offsets=vec_offsets, vec_labels=vec_labels,
        inv_offsets=inv_offsets, inv_postings=inv_postings,
        label_counts=label_counts, blooms=blooms, k_hashes=store.k_hashes)

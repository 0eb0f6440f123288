"""Per-vector Bloom filters for approximate label membership (paper §4.3.1).

The host half of ``repro.core.bloom`` (numpy only): the paper uses a fixed
4 bytes (32 bits) per vector with k hash functions. ``is_member_approx``
for a label set reduces to a single masked compare: a vector passes iff all
required bits are set in its 32-bit word — for a LabelAnd query the union of
every label's bit mask must be present, which is exactly the AND of the
individual checks.

No false negatives by construction: build ORs the exact bit positions. The
device probe lives in ``selectors.is_member_approx`` and the fused hop
kernel, on int32 views of these uint32 words.
"""
from __future__ import annotations

import numpy as np

BLOOM_BITS = 32


def _hash_label(label: np.ndarray | int, seed: int) -> np.ndarray:
    """SplitMix64-style integer hash -> bit position in [0, 32)."""
    with np.errstate(over="ignore"):   # uint64 wraparound is intentional
        x = (np.asarray(label, dtype=np.uint64)
             + np.uint64(0x9E3779B97F4A7C15) * np.uint64(seed + 1))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(BLOOM_BITS)).astype(np.uint32)


def label_bits(labels, k_hashes: int = 2) -> np.ndarray:
    """Bit mask (uint32) with the k hash bits of each label set. labels: (...,)"""
    labels = np.asarray(labels)
    mask = np.zeros(labels.shape, dtype=np.uint32)
    for seed in range(k_hashes):
        mask |= (np.uint32(1) << _hash_label(labels, seed)).astype(np.uint32)
    return mask


def build_blooms(label_offsets: np.ndarray, label_flat: np.ndarray,
                 n_vectors: int, k_hashes: int = 2) -> np.ndarray:
    """Build per-vector 32-bit Bloom words from a CSR label store.

    label_offsets: (N+1,) int64; label_flat: (nnz,) int32 label ids.
    Returns (N,) uint32.
    """
    bits = label_bits(label_flat, k_hashes)                     # (nnz,)
    blooms = np.zeros(n_vectors, dtype=np.uint32)
    # segment-OR via np.bitwise_or.reduceat (empty segments handled below)
    counts = np.diff(label_offsets)
    nonempty = counts > 0
    if bits.size:
        starts = label_offsets[:-1][nonempty]
        blooms[nonempty] = np.bitwise_or.reduceat(bits, starts)
    return blooms


def bloom_pass(blooms, required_mask):
    """Vectorized probe: True where all required bits are present.

    ``blooms``: (N,) words (uint32 numpy, or the int32 tensor view the
    device tiers hold); ``required_mask``: a scalar or broadcastable mask
    of the same width. A mask of 0 means no bloom constraint: all pass.
    Returns a numpy bool array for numpy input, a bool tensor for a
    tensor."""
    req = np.asarray(required_mask, np.uint32)
    if hasattr(blooms, "new_tensor"):          # a tensor of int32 words
        req = blooms.new_tensor(req.view(np.int32))
        return (blooms & req) == req
    return (np.asarray(blooms, np.uint32) & req) == req


def bloom_fp_rate(avg_labels_per_vec: float, k_hashes: int = 2,
                  m_bits: int = BLOOM_BITS, n_query_labels: int = 1) -> float:
    """Analytic false-positive rate (paper §4.3.1 precision estimation).

    Probability a single absent label appears present:
        p1 = (1 - (1 - 1/m)^(k * n_labels))^k
    For a query of q independent labels that must all match (LabelAnd on
    absent labels), fp = p1 ** q.
    """
    fill = 1.0 - (1.0 - 1.0 / m_bits) ** (k_hashes * max(avg_labels_per_vec, 0.0))
    p1 = fill ** k_hashes
    return float(p1 ** n_query_labels)

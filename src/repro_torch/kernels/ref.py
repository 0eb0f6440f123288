"""Plain PyTorch versions of the port's CUDA kernels.

Each function has the signature of its kernel wrapper in ``kernels/ops.py``
and is the version the wrapper runs for tensors on the CPU; ``chip_smoke.py``
holds each CUDA kernel against it on the card. The arithmetic is pinned to
``repro.kernels.ref`` bit for bit:

* ADC sums add ``table[m, code[m]]`` for m = 0..M-1 left to right, each sum
  rounded to float32 — the order of ``repro``'s Pallas kernel
  (``hop_fused.py:62-66``) and of XLA's reduction in ``adc_slab_ref``.
* The PQ tables' squared distances (:func:`sq_dist_fma`) follow XLA-CPU's
  reduction of ``sum(d * d)`` over short rows: a left-to-right fused
  multiply-add chain. PyTorch has no fused multiply-add operator, so each
  step is emulated in float64 (the product of two float32 values is exact
  there) and rounded back to float32.
* Exact re-rank distances (:func:`sq_dist`) need no such pin (the JAX
  package's are compared within 1e-6), but the card and the CPU must agree
  bit for bit, so they are summed as a fixed pairwise tree of elementwise
  float32 additions — a handful of launches for any D, where a chain over
  D = 192 would cost hundreds per hop.

Elementwise arithmetic is identical on the CPU and the card, so both
formulas give the same bits on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

# The single source of the invalid-candidate admission penalty and of the
# "empty" key, as the float32 values they take in every comparison.
INVALID_PENALTY = float(np.float32(1e12))
BIG = float(np.float32(1e30))
VISITED_SLOTS_MAX = 1 << 20   # beyond this the visited set hashes (approx.)


def sq_dist_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 over the last axis, ``a`` and ``b`` broadcast against each
    other: a left-to-right fused multiply-add chain in float32 (see the
    module docstring)."""
    diff = a - b
    acc = None
    for j in range(diff.shape[-1]):
        dj = diff[..., j].double()
        acc = dj * dj if acc is None else dj * dj + acc.double()
        acc = acc.float()
    return acc


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 over the last axis, ``a`` and ``b`` broadcast against each
    other, summed as a pairwise tree (zero-padded to a power of two): the
    same float32 bits on the CPU and the card."""
    sq = (a - b) ** 2
    d = sq.shape[-1]
    width = 1 << max(0, d - 1).bit_length()
    if width != d:
        sq = torch.nn.functional.pad(sq, (0, width - d))
    while sq.shape[-1] > 1:
        h = sq.shape[-1] // 2
        sq = sq[..., :h] + sq[..., h:]
    return sq[..., 0]


def adc_slab_ref(codes_slab: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ADC distances for a pre-gathered code slab.

    codes_slab (..., C, M) uint8/int; table (..., M, K) float32 with the same
    leading dims -> (..., C) float32, summed over m left to right."""
    m, k = table.shape[-2:]
    lead = codes_slab.shape[:-2]
    c = codes_slab.shape[-2]
    idx = codes_slab.long() + torch.arange(m, device=codes_slab.device) * k
    nb = table.numel() // (m * k)
    t = torch.gather(table.reshape(nb, m * k), 1,
                     idx.reshape(nb, c * m)).reshape(nb, c, m)
    d = t[..., 0] + 0.0          # the sums start from +0.0, like XLA's
    for j in range(1, m):
        d = d + t[..., j]
    return d.reshape(lead + (c,))


def pq_scan_ref(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ADC distances of every code row against one table: codes (N, M)
    uint8/int32, table (M, K) float32 -> (N,) float32, sum_m
    table[m, codes[n, m]] added left to right (``repro.kernels.ref``'s
    ``pq_scan_ref``). A code is read as XLA's gather reads it there: a
    negative code wraps once (+K), then it is clamped to [0, K-1]."""
    k = table.shape[-1]
    c = codes.long()
    c = torch.where(c < 0, c + k, c).clamp(0, k - 1)
    return adc_slab_ref(c, table)


def pq_scan_gather_ref(codes: torch.Tensor, ids: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """:func:`pq_scan_ref` of the rows ``ids`` (C,) int32 names in codes
    (N, M): (C,) float32. An id outside [0, N) gives +inf (its row is not
    read), as in :func:`hop_fused_gather_ref`."""
    n = codes.shape[0]
    bad = (ids < 0) | (ids >= n)
    if n == 0:
        return torch.full(ids.shape, float("inf"), dtype=torch.float32,
                          device=ids.device)
    d = pq_scan_ref(codes[torch.where(bad, 0, ids).long()], table)
    return torch.where(bad, float("inf"), d)


def hop_fused_ref(codes_slab, blooms, buckets, in_merged, table, scalars,
                  or_masks, range_field, bucket_lo, bucket_hi):
    """Fused per-hop candidate pass over a pre-gathered (B, C) slab.

    codes_slab (B, C, M) uint8; blooms (B, C) int32 bit-words; buckets
    (B, C, F) int32; in_merged (B, C) bool; table (B, M, K) float32; scalars
    (B, 4) int32 [and_mask, label_mode, merged_mode, combine]; or_masks
    (B, QL); range_field/bucket_lo/bucket_hi (B, NR) int32.

    Returns ``(key, ok)``: key (B, C) = ADC distance + INVALID_PENALTY where
    not ok; ok (B, C) bool — ``selectors.is_member_approx`` on the same ids.
    """
    d = adc_slab_ref(codes_slab, table)

    and_mask = scalars[:, 0:1]
    label_mode = scalars[:, 1:2]
    merged_mode = scalars[:, 2:3]
    combine = scalars[:, 3:4]
    and_ok = (blooms & and_mask) == and_mask                 # (B, C)
    om = or_masks[:, None, :]                                # (B, 1, QL)
    hit_any = ((om != 0) & ((blooms[..., None] & om) == om)).any(-1)
    has_or = (or_masks != 0).any(-1, keepdim=True)

    false = torch.zeros_like(hit_any)
    label_or = torch.where(merged_mode == 1, in_merged | hit_any,
                           torch.where(has_or, hit_any, false))
    label_and = torch.where(merged_mode == 2, in_merged & and_ok, and_ok)
    label_ok = torch.where(label_mode == 1, label_and,
                           torch.where(label_mode == 2, label_or, ~false))
    label_present = label_mode != 0

    f = buckets.shape[-1]
    active = (range_field >= 0)[:, None, :]                  # (B, 1, NR)
    safe_f = torch.where(range_field >= 0, range_field, 0).clamp(max=f - 1)
    v = torch.gather(buckets, 2, safe_f[:, None, :].expand(
        -1, buckets.shape[1], -1))                           # (B, C, NR)
    # a field past the last column reads 0, as in the Pallas kernel
    v = torch.where((range_field < f)[:, None, :], v, 0)
    rok = (v >= bucket_lo[:, None, :]) & (v <= bucket_hi[:, None, :])
    range_ok = (rok | ~active).all(-1)
    range_present = (range_field >= 0).any(-1, keepdim=True)

    ok_and = (label_ok | ~label_present) & (range_ok | ~range_present)
    ok_or = (label_ok & label_present) | (range_ok & range_present)
    any_present = label_present | range_present
    ok = torch.where(any_present, torch.where(combine == 1, ok_or, ok_and),
                     ~false)
    penalty = torch.where(ok, 0.0, INVALID_PENALTY).to(torch.float32)
    return d + penalty, ok


def hop_fused_gather_ref(codes, blooms, buckets, merged_words, ids, table,
                         scalars, or_masks, range_field, bucket_lo,
                         bucket_hi):
    """``hop_fused_ref`` on the slab that ``ids`` (B, C) int32 gathers from
    the stores: codes (N, M) uint8, blooms (N,) int32, buckets (N, F)
    int32, and bit ``ids[b, c]`` of query b's rare-list bitmap
    ``merged_words`` (B, NW) int32. An id outside [0, N) gives key +inf and
    ok False (its row is not read)."""
    n = codes.shape[0]
    bad = (ids < 0) | (ids >= n)
    safe = torch.where(bad, 0, ids).long()
    words = torch.gather(merged_words, 1, safe >> 5)
    in_merged = ((words >> (safe & 31)) & 1).bool()
    key, ok = hop_fused_ref(codes[safe], blooms[safe], buckets[safe],
                            in_merged, table, scalars, or_masks, range_field,
                            bucket_lo, bucket_hi)
    return torch.where(bad, float("inf"), key), ok & ~bad


def or_scatter_ref(words: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Row-wise bitmap OR-scatter, out of place: set bit ``slots[b, j]`` in
    word ``slots[b, j] >> 5`` of row b for every in-range slot; slots < 0 or
    >= NW*32 are dropped (the callers' "skip" sentinel).

    PyTorch has no OR-combining scatter, so — like ``repro``'s reference —
    each row's slots are sorted and deduplicated and each bit is AND-NOTed
    against the word it targets; what remains is a sum of distinct unset
    bits, and addition of those IS bitwise OR. The sum runs on unsigned
    32-bit values held in int64, so no signed overflow occurs."""
    b, nw = words.shape
    n_bits = nw * 32
    s = slots.long()
    s = torch.where((s >= 0) & (s < n_bits), s, n_bits)
    s = torch.sort(s, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    keep = (s < n_bits) & ~dup
    w = torch.where(keep, s >> 5, 0)
    bit = torch.where(keep, torch.bitwise_left_shift(torch.ones_like(s),
                                                     s & 31), 0)
    cur = torch.gather(words.long() & 0xFFFFFFFF, 1, w)
    out = (words.long() & 0xFFFFFFFF).scatter_add(1, w, bit & ~cur)
    out = out - ((out >> 31) & 1) * (1 << 32)      # back to signed int32
    return out.to(torch.int32)


def visited_spec(n_ids: int) -> tuple[int, int]:
    """(n_slots, shift) of the visited slot table over ``n_ids`` ids: exact
    (identity) while the ids fit in VISITED_SLOTS_MAX slots, multiply-shift
    hashed beyond (a collision only skips re-exploring a node)."""
    bits = max(8, int(max(n_ids - 1, 1)).bit_length())
    bits = min(bits, VISITED_SLOTS_MAX.bit_length() - 1)
    return 1 << bits, 32 - bits


def visited_slot(ids: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Visited-table slots of ids >= 0."""
    n_slots, shift = visited_spec(n_ids)
    if n_slots >= n_ids:
        return ids
    # uint32 multiply-shift in int64 arithmetic
    h = (ids.long() * 0x9E3779B1) & 0xFFFFFFFF
    return (h >> shift).int()


def _slots(ids: torch.Tensor, n_ids: int | None) -> torch.Tensor:
    """The slots the in-place and fresh entries set for ``ids``: the ids
    themselves (``n_ids`` None) or their visited slots, with every negative
    id dropped."""
    if n_ids is None:
        return ids
    return torch.where(ids >= 0, visited_slot(ids.clamp(min=0), n_ids), -1)


def or_scatter_ref_(words: torch.Tensor, ids: torch.Tensor,
                    n_ids: int | None = None) -> torch.Tensor:
    """:func:`or_scatter_ref` in place on ``words`` (B, NW) int32, of the
    slots of ``ids`` (B, C) (:func:`_slots`); returns ``words``."""
    return words.copy_(or_scatter_ref(words, _slots(ids, n_ids)))


def or_scatter_new_ref(ids: torch.Tensor, nw: int,
                       n_ids: int | None = None) -> torch.Tensor:
    """A fresh (B, nw) int32 table with the in-range slots of ``ids`` (B, C)
    set (:func:`_slots`)."""
    words = torch.zeros((ids.shape[0], nw), dtype=torch.int32,
                        device=ids.device)
    return or_scatter_ref_(words, ids, n_ids)


def prune_scan_ref(dp_s: torch.Tensor, dcc_s: torch.Tensor, a2: float,
                   r: int) -> torch.Tensor:
    """RobustPrune domination scan over distance-sorted candidates.

    dp_s (B, C) float32 candidate→insert-point distances, ascending per row,
    +inf right pads; dcc_s (B, C, C) float32 pairwise candidate distances in
    the same order. Walks each row's lanes in order: lane i is kept if it is
    not yet pruned, fewer than r are kept and dp[i] is finite; a kept i
    prunes every j with a2·dcc[i, j] <= dp[j]. Returns the (B, C) keep mask.
    """
    b, c = dp_s.shape
    pruned = torch.zeros((b, c), dtype=torch.bool, device=dp_s.device)
    keep = torch.zeros_like(pruned)
    nk = torch.zeros((b,), dtype=torch.int32, device=dp_s.device)
    finite = torch.isfinite(dp_s)
    for i in range(c):
        act = ~pruned[:, i] & (nk < r) & finite[:, i]
        keep[:, i] = act
        newly = act[:, None] & (a2 * dcc_s[:, i, :] <= dp_s)
        pruned = pruned | newly
        pruned[:, i] |= act
        nk = nk + act.int()
    return keep


def _bits32(t: torch.Tensor) -> torch.Tensor:
    """32-bit words as int32 bit patterns: uint32 is viewed, not converted,
    so a word >= 2**31 keeps its bits."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t.to(
        torch.int32)


def approx_probe_ref(blooms: torch.Tensor, buckets: torch.Tensor,
                     or_masks: torch.Tensor,
                     params: torch.Tensor) -> torch.Tensor:
    """Single-field approximate-membership probe over N candidates
    (``repro.kernels.ref.approx_probe_ref``): blooms (N,) uint32/int32 bit
    words, buckets (N,) uint8/int32, or_masks (QL <= 8,) uint32/int32,
    params (8,) int32 = [and_mask, n_or_masks, bucket_lo, bucket_hi,
    label_mode (0 none / 1 and / 2 or), range_on, combine (0 and / 1 or),
    unused] -> (N,) bool.

    Bits are tested in int32: ``(w & m) == m`` has the same answer on the
    int32 and the uint32 reading of the same bits. ``params[1]`` is ignored,
    as in the JAX package: every OR mask is tested and zero masks never
    hit."""
    bl = _bits32(blooms)
    om = _bits32(or_masks)
    prm = params.to(torch.int32)
    and_mask = prm[0]
    and_ok = (bl & and_mask) == and_mask
    hit_any = ((om[None, :] != 0)
               & ((bl[:, None] & om[None, :]) == om[None, :])).any(1)
    label_mode = prm[4]
    true = torch.ones_like(and_ok)
    label_ok = torch.where(label_mode == 1, and_ok,
                           torch.where(label_mode == 2, hit_any, true))
    label_present = label_mode != 0
    bk = buckets.to(torch.int32)
    range_ok = (bk >= prm[2]) & (bk <= prm[3])
    range_present = prm[5] == 1
    ok_and = (label_ok | ~label_present) & (range_ok | ~range_present)
    ok_or = (label_ok & label_present) | (range_ok & range_present)
    any_present = label_present | range_present
    return torch.where(any_present, torch.where(prm[6] == 1, ok_or, ok_and),
                       true)


def l2_rerank_ref(vecs: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances of one query to B rows, vecs (B, D) float32,
    query (D,) float32 -> (B,) float32, in the Pallas kernel's form
    ``|v|^2 - 2 v.q + |q|^2`` (``repro/kernels/l2_rerank.py``), not the
    ``sum((v - q)^2)`` of ``repro``'s jnp oracle: the two differ in the last
    bits, and near-duplicate rows can come out slightly negative here, as
    they do on the TPU. Sums run in PyTorch's order, so this agrees with the
    kernels within float32 rounding, not bit for bit."""
    v = vecs.float()
    q = query.float()
    vv = (v * v).sum(1)
    vq = (v * q[None, :]).sum(1)
    qq = (q * q).sum()
    return vv - 2.0 * vq + qq

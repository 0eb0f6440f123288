"""Selector abstraction (paper §4.1/§4.3): composable filtering rules.

Counterpart of ``repro.core.selectors``. A Selector has two halves:

* **host half** (planning, per query, numpy): estimates selectivity &
  precision, decides which on-SSD attribute indexes to touch (rare-label
  posting lists, range scans), accounts the pages read, and emits a
  ``QueryFilter`` of per-query numpy arrays. A copy of ``repro``'s.
* **device half** (module-level functions on tensors): ``is_member_approx``
  (probes only in-memory structures: Bloom words, bucket codes, the
  pre-merged rare list) and ``is_member`` (exact, reads the record's
  co-located attributes). Where ``repro`` vmaps one query's function over a
  batch, these take the batch as an explicit leading dimension: every
  QueryFilter field and every id/record tensor is (B, ...).

``is_member_approx`` guarantees no false negatives; built-ins follow the
paper's hybrid design (rare labels resolved exactly from fetched postings,
frequent labels via Bloom filters; ranges via 1-byte bucket codes).
uint32 Bloom words and masks cross to the device as int32 bit views, so
bit 31 survives and the bitwise probes are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core.io_sim import PAGE_BYTES
from repro_torch.core.labels import LabelStore
from repro_torch.core.ranges import MultiRangeStore, RangeStore

INT_PAD = np.iinfo(np.int32).max

# label_mode / merged_mode values
L_NONE, L_AND, L_OR = 0, 1, 2
M_NONE, M_OR, M_AND = 0, 1, 2
C_AND, C_OR = 0, 1

NR_DEFAULT = 4   # range-predicate slots per query (IndexConfig.qr)


class QueryFilter(NamedTuple):
    """Per-query data for the built-in selector algebra.

    On the host (``Selector.plan``) the fields are numpy arrays of one
    query; :func:`stack_filters` stacks them along a leading batch dim and
    :func:`filter_to_device` turns the batch into tensors. Shapes per query:
    QL = max query labels, CAP = merged-list cap, NR = range-predicate
    slots; ``range_field = -1`` marks an empty slot.
    """
    # --- approximate (in-memory) half ---
    merged_ids: object        # (CAP,) int32, sorted, padded with INT_PAD
    merged_len: object        # ()  int32
    merged_mode: object       # ()  int32: M_NONE / M_OR / M_AND
    bloom_or_masks: object    # (QL,) uint32 per-frequent-label masks (0 = pad)
    bloom_and_mask: object    # ()  uint32 union mask of frequent labels
    bucket_lo: object         # (NR,) int32 (per-predicate range approx)
    bucket_hi: object         # (NR,) int32
    # --- exact half (verification against record attributes) ---
    q_labels: object          # (QL,) int32, padded with -1
    label_mode: object        # ()  int32: L_NONE / L_AND / L_OR
    range_field: object       # (NR,) int32 numeric-field index, -1 = empty
    range_lo: object          # (NR,) float32
    range_hi: object          # (NR,) float32
    combine: object           # ()  int32: C_AND / C_OR over (label, range)


class InMemory(NamedTuple):
    """The replicated in-memory tier probed by is_member_approx."""
    blooms: torch.Tensor        # (N,) int32 bit view of the uint32 words
    bucket_codes: torch.Tensor  # (N, F) uint8 — one code column per field


def _as_i32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x.astype(np.int32)


def filter_to_device(qf: QueryFilter, device) -> QueryFilter:
    """A host-stacked (B, ...) QueryFilter as tensors on ``device``: uint32
    masks as int32 bit views, ints as int32, bounds as float32."""
    out = {}
    for name, x in qf._asdict().items():
        x = np.asarray(x)
        if name in ("range_lo", "range_hi"):
            x = x.astype(np.float32)
        else:
            x = _as_i32(x)
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return QueryFilter(**out)


def take_filter_rows(qf: QueryFilter, idx: torch.Tensor) -> QueryFilter:
    return QueryFilter(*(x.index_select(0, idx) for x in qf))


def _col(x: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-query (B,) field shaped to broadcast against (B, ...) of ``nd``
    dims."""
    return x.reshape(x.shape[:1] + (1,) * (nd - 1))


def _range_parts(qf: QueryFilter, codes_or_values: torch.Tensor, lo, hi,
                 is_float: bool):
    """AND-of-slots range evaluation. codes_or_values (B, S, F); lo/hi
    (B, NR). Returns (range_ok (B, S), range_present (B, 1))."""
    active = qf.range_field >= 0                            # (B, NR)
    f = codes_or_values.shape[-1]
    safe_f = torch.where(active, qf.range_field, 0).clamp(max=f - 1).long()
    v = torch.gather(codes_or_values, 2, safe_f[:, None, :].expand(
        -1, codes_or_values.shape[1], -1))                  # (B, S, NR)
    lo, hi = lo[:, None, :], hi[:, None, :]
    ok = (v >= lo) & (v < hi) if is_float else (v >= lo) & (v <= hi)
    range_ok = (ok | ~active[:, None, :]).all(-1)
    return range_ok, active.any(-1, keepdim=True)


def _combine(qf: QueryFilter, label_ok, range_ok, range_present):
    label_present = _col(qf.label_mode, 2) != L_NONE
    ok_and = (label_ok | ~label_present) & (range_ok | ~range_present)
    ok_or = (label_ok & label_present) | (range_ok & range_present)
    any_present = label_present | range_present
    return torch.where(any_present,
                       torch.where(_col(qf.combine, 2) == C_OR, ok_or, ok_and),
                       torch.ones_like(ok_and))


def is_member_approx(qf: QueryFilter, ids: torch.Tensor,
                     mem: InMemory) -> torch.Tensor:
    """No-false-negative superset predicate. ids (B, S) -> bool (B, S)."""
    g_bloom = mem.blooms[ids]                               # (B, S)
    in_merged = merged_membership(qf, ids)
    masks = qf.bloom_or_masks[:, None, :]                   # (B, 1, QL)
    hit_any = ((masks != 0) & ((g_bloom[..., None] & masks) == masks)).any(-1)
    has_or = (qf.bloom_or_masks != 0).any(-1, keepdim=True)
    am = _col(qf.bloom_and_mask, 2)
    and_ok = (g_bloom & am) == am
    false = torch.zeros_like(hit_any)
    mm = _col(qf.merged_mode, 2)
    lm = _col(qf.label_mode, 2)
    label_or = torch.where(mm == M_OR, in_merged | hit_any,
                           torch.where(has_or, hit_any, false))
    label_and = torch.where(mm == M_AND, in_merged & and_ok, and_ok)
    label_ok = torch.where(lm == L_AND, label_and,
                           torch.where(lm == L_OR, label_or, ~false))
    codes = mem.bucket_codes[ids].int()                     # (B, S, F)
    range_ok, range_present = _range_parts(qf, codes, qf.bucket_lo,
                                           qf.bucket_hi, is_float=False)
    return _combine(qf, label_ok, range_ok, range_present)


def is_member(qf: QueryFilter, rec_labels: torch.Tensor,
              rec_values: torch.Tensor) -> torch.Tensor:
    """Exact verification against record-resident attributes.

    rec_labels (B, S, ML) int32 padded -1; rec_values (B, S, F) float32.
    Returns (B, S) bool."""
    ql = qf.q_labels                                        # (B, QL)
    qlb = ql[:, None, :, None]
    present = (rec_labels[:, :, None, :] == qlb) & (qlb >= 0)
    contains = present.any(-1)                              # (B, S, QL)
    is_pad = (ql < 0)[:, None, :]
    lab_and = (contains | is_pad).all(-1)
    lab_or = (contains & ~is_pad).any(-1)
    lm = _col(qf.label_mode, 2)
    label_ok = torch.where(lm == L_AND, lab_and,
                           torch.where(lm == L_OR, lab_or,
                                       torch.ones_like(lab_and)))
    range_ok, range_present = _range_parts(qf, rec_values, qf.range_lo,
                                           qf.range_hi, is_float=True)
    return _combine(qf, label_ok, range_ok, range_present)


def merged_membership(qf: QueryFilter, ids: torch.Tensor) -> torch.Tensor:
    """Rare-list membership of ``ids`` (B, S) by binary search over each
    query's sorted merged list."""
    ids = ids.to(qf.merged_ids.dtype).contiguous()
    pos = torch.searchsorted(qf.merged_ids.contiguous(), ids)
    pos = pos.clamp(0, qf.merged_ids.shape[-1] - 1)
    return ((torch.gather(qf.merged_ids, 1, pos) == ids)
            & (pos < qf.merged_len[:, None]))


def merged_table(qf: QueryFilter, n_ids: int) -> torch.Tensor:
    """Batched rare-list membership as a per-query bool table: ``(B,
    n_ids+1)``, row b true at the ids in ``qf.merged_ids[b]``; pad ids
    (INT_PAD) clip into the sentinel column ``n_ids``. One byte per id per
    query: the readable oracle of :func:`merged_table_words`, the packed
    form the search loop carries."""
    ids = qf.merged_ids.clamp(max=n_ids).long()
    table = torch.zeros((ids.shape[0], n_ids + 1), dtype=torch.bool,
                        device=ids.device)
    return table.scatter_(1, ids, True)


def merged_table_words(qf: QueryFilter, n_ids: int) -> torch.Tensor:
    """Batched rare-list membership as per-query bitmaps, 32 ids per int32
    word: ``(B, ceil((n_ids+1)/32))``, bit i of row b set iff id i is in
    query b's merged list. Pad ids (INT_PAD) clip into the sentinel bit
    ``n_ids``, which the hop loop never reads (candidate ids are < n_ids).
    Built by the OR-scatter kernel's fresh-table entry."""
    from repro_torch.kernels import ops
    n_words = (n_ids + 1 + 31) // 32
    return ops.or_scatter_new(qf.merged_ids.clamp(max=n_ids).contiguous(),
                              n_words)


def kernel_view(mem: InMemory) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-memory tier in the fused-kernel layout: ``(blooms (N,) int32,
    bucket_codes (N, F) int32)``. A one-time relayout per search call."""
    return mem.blooms, mem.bucket_codes.int()


def kernel_filter_params(qf: QueryFilter) -> tuple:
    """The approximate half of a device QueryFilter as the fused hop
    kernel's parameter block: ``(scalars (B, 4) [bloom_and_mask,
    label_mode, merged_mode, combine], or_masks (B, QL), range_field,
    bucket_lo, bucket_hi (B, NR))``, all int32 and contiguous."""
    scalars = torch.stack([qf.bloom_and_mask, qf.label_mode, qf.merged_mode,
                           qf.combine], dim=-1).int().contiguous()
    return (scalars, qf.bloom_or_masks.int().contiguous(),
            qf.range_field.int().contiguous(),
            qf.bucket_lo.int().contiguous(), qf.bucket_hi.int().contiguous())


def always_true_filter(ql: int, cap: int, nr: int = NR_DEFAULT) -> QueryFilter:
    """The post-filtering extreme: is_member_approx ≡ True (paper §3)."""
    return QueryFilter(
        merged_ids=np.full(cap, INT_PAD, np.int32), merged_len=np.int32(0),
        merged_mode=np.int32(M_NONE),
        bloom_or_masks=np.zeros(ql, np.uint32), bloom_and_mask=np.uint32(0),
        bucket_lo=np.zeros(nr, np.int32),
        bucket_hi=np.full(nr, 255, np.int32),
        q_labels=np.full(ql, -1, np.int32), label_mode=np.int32(L_NONE),
        range_field=np.full(nr, -1, np.int32),
        range_lo=np.full(nr, -np.inf, np.float32),
        range_hi=np.full(nr, np.inf, np.float32),
        combine=np.int32(C_AND))


def stack_filters(filters: Sequence[QueryFilter]) -> QueryFilter:
    """Stack per-query host filters along a leading batch dimension (numpy;
    the search entry converts the padded batch in one transfer)."""
    return QueryFilter(*(np.stack([np.asarray(x) for x in xs])
                         for xs in zip(*filters)))


# ---------------------------------------------------------------------------
# Host-side planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """Result of Selector.plan(): device data + planning statistics."""
    qfilter: QueryFilter
    selectivity: float
    precision_in: float     # precision of is_member_approx during in-filtering
    precision_pre: float    # precision of the pre-filter superset
    pages_prefetch: int     # X_in: pages read before traversal (rare postings)
    pages_prescan: int      # X_pre: pages a speculative pre-filter scan reads
    force_mech: str | None = None   # bypass the cost model ('pre'|'in'|'post'):
                                    # required when the QueryFilter algebra
                                    # cannot express the constraint and only
                                    # one mechanism preserves correctness


class Selector:
    """Base class. Subclasses implement plan()/pre_filter_approx()."""

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        raise NotImplementedError

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        """Batched superset scan: (superset vector ids, pages read)."""
        raise NotImplementedError

    def selectivity(self) -> float:
        raise NotImplementedError


def _fill_label_fields(base: QueryFilter, **kw) -> QueryFilter:
    return base._replace(**kw)


class LabelSelectorBase(Selector):
    def __init__(self, store: LabelStore, labels: Sequence[int],
                 rare_fetch_cap: int = 2048):
        self.store = store
        self.labels = [int(l) for l in labels]
        self.rare_fetch_cap = int(rare_fetch_cap)
        self._counts = np.array([store.label_counts[l] for l in self.labels],
                                dtype=np.int64)

    def _split_rare(self, cap: int):
        """Greedily mark labels rare (fetch their postings) within the cap."""
        order = np.argsort(self._counts, kind="stable")
        rare, freq, budget = [], [], min(cap, self.rare_fetch_cap)
        for i in order:
            c = int(self._counts[i])
            if c <= budget:
                rare.append(self.labels[i])
                budget -= c
            else:
                freq.append(self.labels[i])
        return rare, freq

    def _fetch_merged(self, rare, op: str):
        pages = 0
        merged = None
        for l in rare:
            post = self.store.postings(l)
            pages += self.store.posting_pages(l)
            if merged is None:
                merged = post
            elif op == "or":
                merged = np.union1d(merged, post)
            else:
                merged = np.intersect1d(merged, post, assume_unique=True)
        return (np.array([], np.int32) if merged is None else merged), pages

    def _bloom_fp1(self) -> float:
        return bloom.bloom_fp_rate(self.store.avg_labels_per_vec,
                                   self.store.k_hashes)


class LabelOrSelector(LabelSelectorBase):
    """Vector passes if it contains at least one query label."""

    def selectivity(self) -> float:
        s = 1.0
        for c in self._counts:
            s *= 1.0 - float(c) / max(1, self.store.n_vectors)
        return 1.0 - s

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        rare, freq = self._split_rare(cap)
        merged, pages = self._fetch_merged(rare, "or")
        merged = merged[:cap]
        qf = always_true_filter(ql, cap, nr)
        ids = np.full(cap, INT_PAD, np.int32)
        ids[:merged.size] = np.sort(merged)
        or_masks = np.zeros(ql, np.uint32)
        for j, l in enumerate(freq[:ql]):
            or_masks[j] = bloom.label_bits(l, self.store.k_hashes)
        q_labels = np.full(ql, -1, np.int32)
        q_labels[:min(len(self.labels), ql)] = self.labels[:ql]
        qf = qf._replace(
            merged_ids=ids, merged_len=np.int32(merged.size),
            merged_mode=np.int32(M_OR if rare else M_NONE),
            bloom_or_masks=or_masks,
            q_labels=q_labels, label_mode=np.int32(L_OR))

        s = self.selectivity()
        fp1 = self._bloom_fp1()
        # P(pass) ≈ P(in rare union) + P(not) * P(any frequent bloom hit)
        s_rare = 1.0 - np.prod([1.0 - self.store.selectivity(l) for l in rare]) \
            if rare else 0.0
        p_freq_hit = 1.0 - np.prod(
            [1.0 - (self.store.selectivity(l) + (1 - self.store.selectivity(l)) * fp1)
             for l in freq]) if freq else 0.0
        p_pass = s_rare + (1.0 - s_rare) * p_freq_hit
        prec = s / max(p_pass, 1e-12)
        return Plan(qf, s, min(1.0, prec), 1.0, pages, self._prescan_pages())

    def _prescan_pages(self) -> int:
        # OR pre-filtering must scan every label's postings.
        return sum(self.store.posting_pages(l) for l in self.labels)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        merged, pages = self._fetch_merged(self.labels, "or")
        return merged.astype(np.int32), pages


class LabelAndSelector(LabelSelectorBase):
    """Vector passes if it contains all query labels."""

    def selectivity(self) -> float:
        s = 1.0
        for c in self._counts:
            s *= float(c) / max(1, self.store.n_vectors)
        return s

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        rare, freq = self._split_rare(cap)
        merged, pages = self._fetch_merged(rare, "and")
        merged = merged[:cap]
        qf = always_true_filter(ql, cap, nr)
        ids = np.full(cap, INT_PAD, np.int32)
        ids[:merged.size] = np.sort(merged)
        and_mask = np.uint32(0)
        for l in freq:
            and_mask |= bloom.label_bits(l, self.store.k_hashes)
        q_labels = np.full(ql, -1, np.int32)
        q_labels[:min(len(self.labels), ql)] = self.labels[:ql]
        qf = qf._replace(
            merged_ids=ids, merged_len=np.int32(merged.size),
            merged_mode=np.int32(M_AND if rare else M_NONE),
            bloom_and_mask=and_mask,
            q_labels=q_labels, label_mode=np.int32(L_AND))

        s = self.selectivity()
        fp1 = self._bloom_fp1()
        p_pass = 1.0
        if rare:
            p_pass *= np.prod([self.store.selectivity(l) for l in rare])
        for l in freq:
            sl = self.store.selectivity(l)
            p_pass *= sl + (1.0 - sl) * fp1
        prec_in = s / max(p_pass, 1e-12)
        # speculative pre-filter scans only rare labels (paper: skip frequent)
        p_pre_pass = np.prod([self.store.selectivity(l) for l in rare]) if rare \
            else 1.0
        prec_pre = s / max(float(p_pre_pass), 1e-12)
        return Plan(qf, s, min(1.0, float(prec_in)), min(1.0, float(prec_pre)),
                    pages, self._prescan_pages())

    def _prescan_pages(self) -> int:
        rare, _ = self._split_rare(self.rare_fetch_cap)
        labels = rare if rare else [self.labels[int(np.argmin(self._counts))]]
        return sum(self.store.posting_pages(l) for l in labels)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        # paper §4.3.1: intersect rare labels only, defer frequent to verify
        rare, _ = self._split_rare(self.rare_fetch_cap)
        if not rare:
            rare = [self.labels[int(np.argmin(self._counts))]]
        merged, pages = self._fetch_merged(rare, "and")
        return merged.astype(np.int32), pages


class RangeSelector(Selector):
    """Vector passes if numeric field ``field`` falls in [lo, hi).

    ``store`` may be a :class:`MultiRangeStore` (``field`` picks the
    column) or a bare per-field :class:`RangeStore` (legacy single-field
    call sites; ``field`` is then the column the emitted predicate refers
    to inside the engine's value matrix, 0 by default).
    """

    def __init__(self, store, lo: float, hi: float, field: int = 0):
        self.store = store
        self.lo, self.hi = float(lo), float(hi)
        self.field = int(field)
        self._fs: RangeStore = store.field_store(self.field) \
            if isinstance(store, MultiRangeStore) else store

    def selectivity(self) -> float:
        return self._fs.selectivity(self.lo, self.hi)

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        qf = _fill_range_slots(always_true_filter(ql, cap, nr), [self])
        s = self.selectivity()
        prec = self._fs.precision(self.lo, self.hi)
        _, pages = self._fs.scan(self.lo, self.hi)
        return Plan(qf, s, prec, 1.0, 0, pages)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        ids, pages = self._fs.scan(self.lo, self.hi)
        return ids.astype(np.int32), pages


def _fill_range_slots(qf: QueryFilter, range_sels) -> QueryFilter:
    """Write a conjunction of range predicates into the NR filter slots."""
    nr = qf.range_field.shape[-1]
    if len(range_sels) > nr:
        raise ValueError(
            f"{len(range_sels)} range predicates exceed the filter's "
            f"{nr} slots (IndexConfig.qr)")
    field = np.full(nr, -1, np.int32)
    lo = np.full(nr, -np.inf, np.float32)
    hi = np.full(nr, np.inf, np.float32)
    blo = np.zeros(nr, np.int32)
    bhi = np.full(nr, 255, np.int32)
    for j, rs in enumerate(range_sels):
        field[j] = rs.field
        lo[j], hi[j] = np.float32(rs.lo), np.float32(rs.hi)
        blo[j], bhi[j] = rs._fs.bucket_range(rs.lo, rs.hi)
    return qf._replace(range_field=field, range_lo=lo, range_hi=hi,
                       bucket_lo=blo, bucket_hi=bhi)


class _Combinator(Selector):
    """Label × range composition shared by And/Or.

    AND accepts one optional label selector plus any number of range
    predicates (a multi-field conjunction — the schema-first query shape);
    OR keeps the two-way (one label + one range) form the approximate
    algebra can express.
    """

    _max_ranges: int | None = None
    _label_required = True

    def __init__(self, children: Sequence[Selector]):
        self.children = list(children)
        lab = [c for c in self.children if isinstance(c, LabelSelectorBase)]
        rng = [c for c in self.children if isinstance(c, RangeSelector)]
        assert len(lab) + len(rng) == len(self.children) and len(lab) <= 1, \
            "built-in combinators compose ≤1 label selector with range " \
            "selectors; fuse or subclass Selector for other trees"
        assert rng, "built-in combinators need ≥1 range selector"
        if self._label_required:
            assert len(lab) == 1, \
                f"{type(self).__name__} needs exactly one label selector"
        if self._max_ranges is not None:
            assert len(rng) <= self._max_ranges, \
                f"{type(self).__name__} takes ≤{self._max_ranges} ranges"
        self.label_sel = lab[0] if lab else None
        self.range_sels: list = rng

    @property
    def range_sel(self) -> RangeSelector:
        """First range child (legacy two-way accessor)."""
        return self.range_sels[0]

    def _merge_plans(self, ql, cap, nr, combine_code):
        if self.label_sel is not None:
            lp = self.label_sel.plan(ql, cap, nr)
        else:
            lp = Plan(always_true_filter(ql, cap, nr), 1.0, 1.0, 1.0, 0, 0)
        rps = [r.plan(ql, cap, nr) for r in self.range_sels]
        qf = _fill_range_slots(lp.qfilter, self.range_sels)
        qf = qf._replace(combine=np.int32(combine_code))
        return lp, rps, qf


class AndSelector(_Combinator):
    """AND of children; pre-filtering prunes the heavy branch (paper §4.3.3).

    Joint selectivity is the clamped product of per-child marginals
    (cost_model.joint_and_selectivity) — the independence estimate that
    keeps route choice and ``effective_l`` sane for multi-field filters.
    """

    _label_required = False

    def selectivity(self) -> float:
        from repro_torch.core import cost_model
        margins = [c.selectivity() for c in self.children]
        return cost_model.joint_and_selectivity(margins)

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        lp, rps, qf = self._merge_plans(ql, cap, nr, C_AND)
        s = self.selectivity()
        p_pass = lp.selectivity / max(lp.precision_in, 1e-12)
        for rp in rps:
            p_pass *= rp.selectivity / max(rp.precision_in, 1e-12)
        prec_in = s / max(p_pass, 1e-12)
        # pre-filter: scan only the lowest-selectivity child
        cheap = min([lp] + rps, key=lambda p: p.selectivity) \
            if self.label_sel is not None else min(rps,
                                                   key=lambda p: p.selectivity)
        prec_pre = s / max(cheap.selectivity / max(cheap.precision_pre, 1e-12),
                           1e-12)
        return Plan(qf, s, min(1.0, prec_in), min(1.0, prec_pre),
                    lp.pages_prefetch, cheap.pages_prescan)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        cheap = min(self.children, key=lambda c: c.selectivity())
        return cheap.pre_filter_approx()


class MatchAllSelector(Selector):
    """No constraint: every record is valid (unfiltered top-k search)."""

    def __init__(self, n_vectors: int):
        self.n_vectors = int(n_vectors)

    def selectivity(self) -> float:
        return 1.0

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        pages = max(1, self.n_vectors * 4 // PAGE_BYTES)
        return Plan(always_true_filter(ql, cap, nr), 1.0, 1.0, 1.0, 0, pages)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        pages = max(1, self.n_vectors * 4 // PAGE_BYTES)
        return np.arange(self.n_vectors, dtype=np.int32), pages


class MaskSelector(Selector):
    """Exact-membership fallback for constraints the built-in QueryFilter
    algebra cannot express (arbitrary AND/OR trees, >QL label slots, range
    predicates over more fields than the NR slots, …).

    The valid-id set is computed exactly on the host (attribute-index
    scans, pages accounted by the caller) and the query is *forced* down
    the pre-filtering path: the candidate superset IS the exact valid set,
    so there are no false negatives (completeness) and no false positives
    (the always-true QueryFilter never rejects a candidate, but only valid
    ids ever enter the pool). In-/post-filtering would consult the vacuous
    device filter and return invalid results, hence ``force_mech='pre'``.
    """

    def __init__(self, valid_ids: np.ndarray, n_vectors: int, pages: int):
        self.valid_ids = np.asarray(valid_ids, np.int32)
        self.n_vectors = int(n_vectors)
        self.pages = int(pages)

    def selectivity(self) -> float:
        return self.valid_ids.size / max(1, self.n_vectors)

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        return Plan(always_true_filter(ql, cap, nr), self.selectivity(),
                    1.0, 1.0, 0, self.pages, force_mech="pre")

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        return self.valid_ids, self.pages


class OrSelector(_Combinator):
    """OR of children; pre-filtering must evaluate every branch."""

    _max_ranges = 1
    _label_required = True

    def selectivity(self) -> float:
        sl = self.label_sel.selectivity()
        sr = self.range_sel.selectivity()
        return 1.0 - (1.0 - sl) * (1.0 - sr)

    def plan(self, ql: int, cap: int, nr: int = NR_DEFAULT) -> Plan:
        lp, rps, qf = self._merge_plans(ql, cap, nr, C_OR)
        rp = rps[0]
        s = self.selectivity()
        pl = lp.selectivity / max(lp.precision_in, 1e-12)
        pr = rp.selectivity / max(rp.precision_in, 1e-12)
        p_pass = 1.0 - (1.0 - pl) * (1.0 - pr)
        prec_in = s / max(p_pass, 1e-12)
        return Plan(qf, s, min(1.0, prec_in), 1.0,
                    lp.pages_prefetch, lp.pages_prescan + rp.pages_prescan)

    def pre_filter_approx(self) -> tuple[np.ndarray, int]:
        a, pa = self.label_sel.pre_filter_approx()
        b, pb = self.range_sel.pre_filter_approx()
        return np.union1d(a, b).astype(np.int32), pa + pb

"""Batched best-first graph search with speculative / strict / post filtering.

Counterpart of ``repro.core.search`` (paper §3–§4). The JAX package expresses
the hop loop as a ``lax.while_loop`` inside one jit; here the loop is a
Python loop over eagerly launched tensor operations, one hop at a time, with
the whole query batch as the leading dimension of every tensor, so the
record fetches of a batch coalesce into one gather per hop.

Modes
-----
* ``post``      — plain traversal; validity is checked only at verification.
* ``spec_in``   — speculative in-filtering: direct + 2-hop neighbors are
                  screened by the fused hop kernel
                  (``kernels.ops.hop_fused_gather``, which gathers their
                  rows itself: ADC distance, Bloom/bucket membership,
                  penalty key); up to R
                  approx-valid neighbors are kept per hop, back-filled with
                  invalid *direct* neighbors (bridge nodes).
* ``strict_in`` — the strict baseline: every neighbor's exact attributes are
                  read before it may enter the pool (+1 page per neighbor).

Exact verification piggybacks on the re-rank fetch. Under a
:class:`~repro_torch.core.faults.FaultPlan` every slab read walks the
retry → hedge → degrade ladder (``core/faults.py``): a row whose every
attempt failed is answered from the in-memory tier (ADC distance and
approximate membership) and its neighbours are not expanded.

Hop pipeline: a per-query word-packed visited bitmap (built by
``kernels.ops.or_scatter_new`` at seeding and updated in place by
``kernels.ops.or_scatter_`` every hop), a key-sorted pool merged by one
stable sort, an incremental early-termination bound, and the cross-hop
prefetch (the next frontier is selected at the end of a hop and its records
are gathered before the next hop runs). Every tie is broken by lower index
through stable sorts, as ``jax.lax.top_k`` and ``jnp.argsort`` break them,
so the port follows the JAX package's trajectory query for query.

Execution: :func:`run_hops` advances a batch ``n_hops`` hops (rows that
settled are exact fixed points of the hop step, so running a whole chunk
changes nothing for them) by replaying a hop captured as CUDA graphs
(:class:`_HopGraph`): with no host synchronisation inside on the device
backend, with the frontier's fetch between the graphs on the disk tier;
every driver takes a ``fetch_fn``, the disk tier's included
(``storage/disk.py``: one host copy of the ids a hop);
:func:`filtered_search_pipelined` reads the active mask back one chunk late
(a non-blocking copy into pinned memory behind a CUDA event) and compacts
surviving queries into power-of-two buckets — bit-identical to the
single-shot :func:`filtered_search`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import io_sim
from repro_torch.core import pq as pq_mod
from repro_torch.core.faults import FaultPlan
from repro_torch.core.records import RecordStore
from repro_torch.core.selectors import (InMemory, QueryFilter,
                                        filter_to_device, is_member,
                                        is_member_approx, kernel_filter_params,
                                        kernel_view, merged_table_words,
                                        take_filter_rows)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import BIG, INVALID_PENALTY, sq_dist, \
    visited_slot, visited_spec
from repro_torch.utils import trace

DEFAULT_HOP_CHUNK = 32    # hops between the driver's compaction checks
MIN_COMPACT_BUCKET = 8    # narrowest bucket the driver compacts into


@dataclasses.dataclass(frozen=True)
class SearchParams:
    l_search: int           # candidate pool length L
    k: int = 10
    beam_width: int = 1     # W records fetched per hop
    max_hops: int = 256
    mode: str = "spec_in"   # 'post' | 'spec_in' | 'strict_in'
    l_valid: int = 0        # early-exit once this many verified-valid found
                            # (0 -> defaults to l_search)
    prefetch_depth: int = 2  # record slabs in flight per query (feeds the
                            # modeled SSD latency only; results invariant)
    fault_plan: FaultPlan | None = None
                            # seeded fault injection on the frontier slab
                            # reads (core/faults.py); None, or a plan whose
                            # rates are all zero, runs the clean hop step

    def __post_init__(self):
        assert self.mode in ("post", "spec_in", "strict_in")
        assert 1 <= self.prefetch_depth <= io_sim.IOModel.parallelism, (
            f"prefetch_depth={self.prefetch_depth} outside "
            f"[1, IOModel.parallelism={io_sim.IOModel.parallelism}]")


class SearchResult(NamedTuple):
    ids: torch.Tensor          # (B, k) int32 — verified-valid top-k (-1 pad)
    dists: torch.Tensor        # (B, k) float32 exact distances
    io_pages: torch.Tensor     # (B,) int32 pages fetched
    hops: torch.Tensor         # (B,) int32 beam-loop iterations
    dist_comps: torch.Tensor   # (B,) int32 PQ distance computations
    approx_checks: torch.Tensor  # (B,) int32 is_member_approx evaluations
    n_valid: torch.Tensor      # (B,) int32 verified-valid results found
    fp_explored: torch.Tensor  # (B,) int32 explored records verified invalid
    explored: torch.Tensor     # (B,) int32 records fetched & exact-verified
    faults: torch.Tensor       # (B,) int32 injected fault events
    retries: torch.Tensor      # (B,) int32 extra read attempts (retries +
                               # hedged reads)
    degraded: torch.Tensor     # (B,) int32 rows that exhausted the ladder
                               # and were answered from the in-memory tier


def local_fetch(store: RecordStore, ids: torch.Tensor) -> dict:
    """Single-device record fetch: plain gathers of the flat ``ids``."""
    ids = ids.long()
    rec = {
        "vectors": store.vectors.index_select(0, ids),
        "neighbors": store.neighbors.index_select(0, ids),
        "dense_neighbors": store.dense_neighbors.index_select(0, ids),
        "rec_labels": store.rec_labels.index_select(0, ids),
        "rec_values": store.rec_values.index_select(0, ids),
    }
    if store.cand_first is not None:
        rec["cand_first"] = store.cand_first.index_select(0, ids)
    return rec


# ---------------------------------------------------------------------------
# Hop-pipeline primitives
# ---------------------------------------------------------------------------

def _bit_test(words: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Bit ``slots[b, j]`` of row b of a word-packed bitmap (signed words:
    the arithmetic shift then ``& 1`` reads bit 31 correctly)."""
    w = torch.gather(words, 1, (slots >> 5).long())
    return ((w >> (slots & 31)) & 1).bool()


def _stable_order(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True).indices


def _first_occurrence(cand: torch.Tensor, live: torch.Tensor,
                      n_ids: int) -> torch.Tensor:
    """True at the first slab-order occurrence of each id (last axis): a
    stable sort keeps equal ids in slab order."""
    key = torch.where(live, cand, n_ids)
    srt, order = torch.sort(key, dim=-1, stable=True)
    first_sorted = torch.ones_like(srt, dtype=torch.bool)
    first_sorted[..., 1:] = srt[..., 1:] != srt[..., :-1]
    return torch.zeros_like(first_sorted).scatter_(-1, order, first_sorted)


def default_distance(distance_fn) -> bool:
    """``None`` and ``pq.adc_lookup`` both mean the default ADC distance,
    which the fused path computes itself."""
    return distance_fn is None or distance_fn is pq_mod.adc_lookup


def row_distance(distance_fn, codes_slab: torch.Tensor,
                 tables: torch.Tensor) -> torch.Tensor:
    """``distance_fn`` over a gathered code slab (B, S, M) against tables
    (B, M, K) -> (B, S). The contract is ``repro``'s, one query at a time:
    ``distance_fn(codes (S, M), table (M, K)) -> (S,)``; ``repro`` vmaps it,
    and since a ``ctypes`` kernel launch cannot be vmapped, a custom
    function is called once per query row (``kernels.ops.pq_scan`` so runs
    B launches). The default, whose leading dims batch, is one call."""
    if default_distance(distance_fn):
        return pq_mod.adc_lookup(codes_slab, tables)
    return torch.stack([distance_fn(codes_slab[b], tables[b])
                        for b in range(codes_slab.shape[0])])


def _put_rows(buf: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """``buf[b, pos[b, j]] = val[b, j]`` for active rows; inactive rows are
    left as they are (the JAX package drops their writes)."""
    old = torch.gather(buf, 1, pos)
    return buf.scatter(1, pos, torch.where(active[:, None], val, old))


# ---------------------------------------------------------------------------
# Search state
# ---------------------------------------------------------------------------

class QueryCtx(NamedTuple):
    """Per-query constants of one search call (leading dim B)."""
    queries: torch.Tensor     # (B, D) float32
    tables: torch.Tensor      # (B, M, ksub) ADC distance tables
    qf: QueryFilter           # device filter tensors
    merged_tbl: torch.Tensor  # (B, ceil((n_ids+1)/32)) int32 rare-list
                              # bitmap ((B, 1) dummy outside spec_in)


class HopState(NamedTuple):
    """Per-query mutable search state carried across hops (leading dim B).
    No hop operation mixes query rows, so taking or putting rows of this
    tuple (straggler compaction) leaves each query's trajectory unchanged.

    A hop consumes the state it is given: :func:`_hop_step` updates
    ``visited`` in place (``kernels.ops.or_scatter_``) and returns it in the
    new state, so after a hop the old state's ``visited`` is the new one's.
    A caller that needs the state from before a hop clones it first
    (``HopState(*(t.clone() for t in st))``); ``take_rows``/``put_rows``
    copy rows, so a compacted state shares no tensor with the full one."""
    pool_ids: torch.Tensor    # (B, P) int32
    pool_key: torch.Tensor    # (B, P) float32, key-ascending
    pool_exp: torch.Tensor    # (B, P) bool
    visited: torch.Tensor     # (B, n_slots // 32) int32 bit-words
    res_ids: torch.Tensor     # (B, res_cap) int32
    res_d: torch.Tensor       # (B, res_cap) float32
    res_valid: torch.Tensor   # (B, res_cap) bool
    vtop: torch.Tensor        # (B, l_valid) float32 sorted valid top-l
    n_okc: torch.Tensor       # (B,) int32
    counters: torch.Tensor    # (B, 7) int32: io, dist, approx, hops,
                              #               faults, retries, degraded
    active: torch.Tensor      # (B,) bool
    cur_ids: torch.Tensor     # (B, W) int32 — prefetched frontier
    cur_live: torch.Tensor    # (B, W) bool


def take_rows(tup, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of a state/ctx tuple."""
    if isinstance(tup, QueryCtx):
        return QueryCtx(tup.queries.index_select(0, idx),
                        tup.tables.index_select(0, idx),
                        take_filter_rows(tup.qf, idx),
                        tup.merged_tbl.index_select(0, idx))
    return type(tup)(*(t.index_select(0, idx) for t in tup))


def put_rows(full: HopState, part: HopState, idx: torch.Tensor,
             valid: torch.Tensor) -> HopState:
    """``full`` with rows ``idx[valid]`` replaced by ``part[valid]``."""
    src = torch.nonzero(valid).squeeze(1)
    dst = idx.index_select(0, src)
    return HopState(*(f.index_copy(0, dst, p.index_select(0, src))
                      for f, p in zip(full, part)))


def _select_frontier(pool_ids, pool_key, pool_exp, active, W: int):
    """Best-W unexplored pool rows (sorted pool ⇒ one stable sort), marked
    explored where the row is active. Returns (cur_ids, cur_live,
    pool_exp')."""
    masked = torch.where(pool_exp, BIG, pool_key)
    sel = _stable_order(masked, 1)[:, :W]
    cur_ids = torch.gather(pool_ids, 1, sel)
    cur_live = (torch.gather(masked, 1, sel) < BIG) & active[:, None]
    pool_exp = _put_rows(pool_exp, sel, torch.ones_like(cur_live), active)
    return cur_ids, cur_live, pool_exp


def _init(store, codes, codebook, mem, qf, queries, entry, params, entries,
          distance_fn=None):
    """Seed the pool/visited/result state and select the first frontier."""
    p = params
    l_valid = p.l_valid or p.l_search
    P, W = p.l_search, p.beam_width
    res_cap = p.max_hops * W
    B = queries.shape[0]
    dev = queries.device
    n_ids = codes.shape[0]
    n_slots, _ = visited_spec(n_ids)
    if entries is None:
        entries = torch.full((B, 1), int(entry), dtype=torch.int32,
                             device=dev)
    E = entries.shape[1]
    assert E <= P, "entry seeds exceed the pool length"

    tables = pq_mod.distance_table(codebook, queries)        # (B, M, K)
    if p.mode == "spec_in":
        merged_tbl = merged_table_words(qf, n_ids)
    else:
        merged_tbl = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    ent_valid = entries >= 0
    safe_ent = torch.where(ent_valid, entries, 0)
    entry_d = row_distance(distance_fn, codes[safe_ent.long()],
                           tables)                           # (B, E)
    entry_ok = is_member_approx(qf, safe_ent, mem) & ent_valid
    entry_key = torch.where(
        ent_valid, entry_d + torch.where(entry_ok, 0.0, INVALID_PENALTY),
        BIG)
    order0 = _stable_order(entry_key, 1)
    pool_ids = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    pool_ids[:, :E] = torch.gather(torch.where(ent_valid, entries, -1), 1,
                                   order0)
    pool_key = torch.full((B, P), BIG, dtype=torch.float32, device=dev)
    pool_key[:, :E] = torch.gather(entry_key, 1, order0)
    pool_exp = torch.ones((B, P), dtype=torch.bool, device=dev)
    pool_exp[:, :E] = torch.gather(~ent_valid, 1, order0)

    # n_slots is 2^bits with bits >= 8, so the word table divides evenly;
    # the fresh-table entry drops the invalid (< 0) entries
    visited = kops.or_scatter_new(entries.contiguous(), n_slots // 32, n_ids)

    res_ids = torch.full((B, res_cap), -1, dtype=torch.int32, device=dev)
    res_d = torch.full((B, res_cap), BIG, dtype=torch.float32, device=dev)
    res_valid = torch.zeros((B, res_cap), dtype=torch.bool, device=dev)
    vtop = torch.full((B, l_valid), BIG, dtype=torch.float32, device=dev)
    n_okc = torch.zeros((B,), dtype=torch.int32, device=dev)
    counters = torch.zeros((B, 7), dtype=torch.int32, device=dev)
    active = (~pool_exp & (pool_key < BIG)).any(1)

    cur_ids, cur_live, pool_exp = _select_frontier(pool_ids, pool_key,
                                                   pool_exp, active, W)
    st = HopState(pool_ids, pool_key, pool_exp, visited, res_ids, res_d,
                  res_valid, vtop, n_okc, counters, active, cur_ids, cur_live)
    return QueryCtx(queries, tables, qf, merged_tbl), st


def _hop_step(store, codes, mem, params, ctx, mc, st, rec,
              fetch_fn=local_fetch, distance_fn=None) -> HopState:
    """Consume the in-flight record slab for one hop, merge, and select the
    next frontier (the step numbering follows ``repro``'s ``_hop_step``).
    ``st`` is consumed: its ``visited`` words are updated in place and
    returned in the new state (see :class:`HopState`). ``fetch_fn`` reads
    the strict_in neighbours' attributes (see :func:`run_hops`). A custom
    ``distance_fn`` (:func:`row_distance`) computes every slab's ADC
    distance in place of the fused sum, and spec_in then screens with
    ``is_member_approx`` instead of the fused kernel (``mc`` is None).
    Its phases are the spans ``hop.rerank`` (2'-3), ``hop.expand`` (4-5),
    ``hop.select`` (6-7) and ``hop.settle`` (8, 1'). Where :func:`run_hops`
    replays a captured hop, this function (and so its spans) runs only when
    the hop is captured, twice: the warm-up and the capture itself; the
    ``hop.*`` host seconds then belong to captures. Its two hand-written
    kernels are called through :func:`_entry`, which a capture leaves out
    of the graph."""
    p = params
    l_valid = p.l_valid or p.l_search
    P, W = p.l_search, p.beam_width
    R = store.degree
    Rd = store.dense_degree if p.mode == "spec_in" else 0
    C = R + Rd
    rec_pages = store.pages_dense if p.mode == "spec_in" else store.pages_std
    n_ids = codes.shape[0]
    (pool_ids, pool_key, pool_exp, visited, res_ids, res_d, res_valid,
     vtop, n_okc, counters, active, cur_ids, cur_live) = st
    queries, tables, qf, merged_tbl = ctx
    B, D = queries.shape
    dev = queries.device
    w_iota = torch.arange(W, device=dev)[None, :]
    hops = counters[:, 3]

    def slab_dist(ids_slab):
        return row_distance(distance_fn, codes[ids_slab.long()], tables)

    with trace.span("hop.rerank"):
        # ---- 2'. the carried slab ----
        vecs = rec["vectors"].reshape(B, W, D)
        nbrs = rec["neighbors"].reshape(B, W, R)
        rl = rec["rec_labels"].reshape(B, W, -1)
        rv = rec["rec_values"].reshape(B, W, -1)
        io = counters[:, 0] + cur_live.sum(1, dtype=torch.int32) * rec_pages

        # ---- 2''. fault ladder on the slab read (core/faults.py) ----
        # Retry → hedge → degrade. Every draw is a stateless hash of
        # (record id, that query's own hop counter, attempt), so compaction
        # can gather rows in any order and no draw changes. Rows whose
        # every attempt drew bad are "degraded".
        plan = p.fault_plan
        faults_c, retries_c, degraded_c = (counters[:, 4], counters[:, 5],
                                           counters[:, 6])
        degraded_rows = None
        if plan is not None and plan.reads_faulty:
            ids_safe = torch.where(cur_live, cur_ids, 0)
            hcol = hops[:, None]
            pending = faults_mod.read_attempt_bad(ids_safe, hcol, 0,
                                                  plan) & cur_live
            n_faults = pending.sum(1, dtype=torch.int32)
            n_retries = torch.zeros_like(n_faults)
            for a in range(1, plan.attempts):
                n_retries = n_retries + pending.sum(1, dtype=torch.int32)
                pending = pending & faults_mod.read_attempt_bad(ids_safe, hcol,
                                                                a, plan)
                n_faults = n_faults + pending.sum(1, dtype=torch.int32)
            degraded_rows = pending
            spikes = faults_mod.read_spike(ids_safe, hcol, plan) & cur_live
            faults_c = faults_c + n_faults + spikes.sum(1, dtype=torch.int32)
            retries_c = retries_c + n_retries
            degraded_c = degraded_c + degraded_rows.sum(1, dtype=torch.int32)
            io = io + n_retries * rec_pages      # each retry re-reads pages

        # ---- 3. re-rank + piggybacked exact verification ----
        ex_d = torch.where(cur_live, sq_dist(vecs, queries[:, None, :]), BIG)
        ex_ok = is_member(qf, rl, rv) & cur_live
        if degraded_rows is not None:
            # a degraded row never saw its record: its ADC distance and approx
            # membership (a no-false-negative superset) stand in for it
            deg_d = torch.where(cur_live, slab_dist(ids_safe), BIG)
            deg_ok = is_member_approx(qf, ids_safe, mem) & cur_live
            ex_d = torch.where(degraded_rows, deg_d, ex_d)
            ex_ok = torch.where(degraded_rows, deg_ok, ex_ok)
        pos = torch.where(active[:, None], hops[:, None].long() * W + w_iota,
                          w_iota)
        res_ids = _put_rows(res_ids, pos, torch.where(cur_live, cur_ids, -1),
                            active)
        res_d = _put_rows(res_d, pos, ex_d, active)
        res_valid = _put_rows(res_valid, pos, ex_ok, active)
        # incremental early-termination bound: merge the W new verified
        # distances into the sorted top-l_valid buffer
        vtop = torch.sort(torch.cat([vtop, torch.where(ex_ok, ex_d, BIG)], 1),
                          dim=1, stable=True).values[:, :l_valid]
        n_okc = n_okc + ex_ok.sum(1, dtype=torch.int32)

    with trace.span("hop.expand"):
        # ---- 4. candidate slab + visited-set dedup ----
        if p.mode == "spec_in":
            dn = rec["dense_neighbors"].reshape(B, W, Rd)
            cand = torch.cat([nbrs, dn], dim=2)                  # (B, W, C)
        else:
            cand = nbrs
        expand_live = (cur_live if degraded_rows is None
                       else cur_live & ~degraded_rows)
        cand = torch.where(expand_live[:, :, None], cand, -1).reshape(B, W * C)
        live = cand >= 0
        safe_cand = torch.where(live, cand, 0)
        seen = _bit_test(visited, visited_slot(safe_cand, n_ids))
        if W == 1 and "cand_first" in rec:
            # W=1: the slab is one record's candidate list — read its
            # precomputed first-occurrence mask (records.candidate_first_mask)
            first = rec["cand_first"].reshape(B, -1)[:, :C]
        else:
            first = _first_occurrence(cand, live, n_ids)
        fresh = live & ~seen & first

        # ---- 5. fused candidate pass (distance + membership + key) ----
        if p.mode == "post":
            ok = fresh
            key_slab = slab_dist(safe_cand)
            approx_c = counters[:, 2]
        elif p.mode == "spec_in":
            if mc is not None:
                bl_i32, bc_i32, (f_scal, f_om, f_rf, f_blo, f_bhi) = mc
                # the kernel gathers each candidate's code row, bloom word,
                # bucket words and rare-list bit itself
                key_slab, ok_approx = _entry(
                    "hop_fused_gather", codes, bl_i32, bc_i32, merged_tbl,
                    safe_cand, tables, f_scal, f_om, f_rf, f_blo, f_bhi)
            else:
                ok_approx = is_member_approx(qf, safe_cand, mem)
                key_slab = slab_dist(safe_cand) + torch.where(
                    ok_approx, 0.0, INVALID_PENALTY)
            ok = ok_approx & fresh
            approx_c = counters[:, 2] + live.sum(1, dtype=torch.int32)
        else:  # strict_in: read every fresh neighbor's attributes from "SSD"
            if getattr(fetch_fn, "wants_ctx", False):
                # disk tier: the device-resident bloom/bucket words gate
                # the attribute reads BEFORE any page is read (the paper's
                # saved I/O). The gate is a no-false-negative superset, so
                # a gated-out row's poisoned attributes (labels -1, values
                # NaN) fail exact membership exactly where its real
                # attributes would
                gate = is_member_approx(qf, safe_cand, mem)
                nrec = fetch_fn(store, torch.stack(
                    [safe_cand.reshape(-1), fresh.reshape(-1).int(),
                     gate.reshape(-1).int()]), attrs_only=True)
            else:
                nrec = fetch_fn(store, safe_cand.reshape(-1))
            n_rl = nrec["rec_labels"].reshape(B, W * C, -1)
            n_rv = nrec["rec_values"].reshape(B, W * C, store.n_fields)
            ok = is_member(qf, n_rl, n_rv) & fresh
            io = io + fresh.sum(1, dtype=torch.int32)  # 1 page / neighbor
            key_slab = slab_dist(safe_cand)
            approx_c = counters[:, 2]

    with trace.span("hop.select"):
        # ---- 6. slot selection: up to R approx-valid, bridge back-fill ----
        if p.mode == "spec_in":
            okr = ok.reshape(B, W, C)
            is_direct = torch.arange(C, device=dev) < R
            fill = fresh.reshape(B, W, C) & ~okr & is_direct
            rank_ok = torch.cumsum(okr.int(), dim=2) - 1
            rank_fill = torch.cumsum(fill.int(), dim=2) - 1
            n_ok_row = okr.sum(2, keepdim=True)
            order_key = torch.where(
                okr, rank_ok.float(),
                torch.where(fill, (n_ok_row + rank_fill).float(), BIG))
            take = _stable_order(order_key, 2)[:, :, :R]          # (B, W, R)
            sel_ok = torch.gather(okr, 2, take).reshape(B, W * R)
            sel_fill = torch.gather(fill, 2, take).reshape(B, W * R)
            sel_live = sel_ok | sel_fill
            sel_ids = torch.gather(cand.reshape(B, W, C), 2, take).reshape(
                B, W * R)
            sel_key = torch.gather(key_slab.reshape(B, W, C), 2, take).reshape(
                B, W * R)
            new_ids = torch.where(sel_live, sel_ids, -1)
            new_key = torch.where(sel_live, sel_key, BIG)
        else:
            sel_live = ok
            new_ids = torch.where(ok, cand, -1)
            new_key = torch.where(ok, key_slab, BIG)
        dist_c = counters[:, 1] + sel_live.sum(1, dtype=torch.int32)
        # mark *admitted* candidates visited (a fresh candidate that loses
        # slot selection stays unmarked and may be re-proposed by another
        # parent): new_ids is -1 wherever sel_live is False, and the
        # in-place entry drops those; the state's visited words are updated
        # where they lie
        visited = _entry("or_scatter_", visited, new_ids, n_ids)

        # ---- 7. sorted-pool merge: concatenate + one stable sort ----
        all_key = torch.cat([pool_key, new_key], 1)
        srt, midx = torch.sort(all_key, dim=1, stable=True)
        midx = midx[:, :P]
        pool_key = srt[:, :P]
        pool_ids = torch.gather(torch.cat([pool_ids, new_ids], 1), 1, midx)
        pool_exp = torch.gather(
            torch.cat([pool_exp, torch.zeros_like(sel_live)], 1), 1, midx)

    with trace.span("hop.settle"):
        # ---- 8. per-query termination ----
        hops_new = hops + active.int()
        frontier = (~pool_exp & (pool_key < BIG)).any(1)
        best_unexp = torch.where(pool_exp, BIG, pool_key).min(1).values
        settled = (n_okc >= l_valid) & (best_unexp > vtop[:, l_valid - 1])
        active = active & (hops_new < p.max_hops) & frontier & ~settled
        counters = torch.stack([io, dist_c, approx_c, hops_new, faults_c,
                                retries_c, degraded_c], 1).int()

        # ---- 1'. select the NEXT frontier (its fetch follows this step) ----
        cur_ids, cur_live, pool_exp = _select_frontier(pool_ids, pool_key,
                                                       pool_exp, active, W)
    return HopState(pool_ids, pool_key, pool_exp, visited, res_ids, res_d,
                    res_valid, vtop, n_okc, counters, active, cur_ids,
                    cur_live)


def _issue(store: RecordStore, st: HopState, params: SearchParams,
           fetch_fn=local_fetch) -> dict:
    """Fetch the frontier's records. A ``fetch_fn`` marked ``wants_ctx``
    (the disk tier's, ``storage/disk.py``) reads on the host: it receives
    the ids packed over each row's hop counter as it stands at issue (its
    fault draws key on the same (id, hop) pairs as the hop step's ladder)
    and the rows' liveness (dead rows read nothing), one (3, B·W) int32
    tensor that it copies to the host at once, and the record flavour
    (dense in spec_in). While this thread captures a hop the packing is
    captured and the call is left out of the graph
    (:meth:`_HopGraph.hole`)."""
    ids = torch.where(st.cur_live, st.cur_ids, 0).reshape(-1)
    if not getattr(fetch_fn, "wants_ctx", False):
        return fetch_fn(store, ids)
    W = params.beam_width
    packed = torch.stack([ids, st.counters[:, 3, None].expand(-1, W)
                          .reshape(-1), st.cur_live.reshape(-1).int()])
    dense = params.mode == "spec_in"
    graph = getattr(_capture, "graph", None)
    if graph is not None:
        return graph.hole("fetch", (fetch_fn, store, packed, dense))
    return fetch_fn(store, packed, dense=dense)


def _mc(mem: InMemory, ctx: QueryCtx, params: SearchParams,
        distance_fn=None, buckets=None):
    """The fused kernel's per-call inputs (spec_in with the default
    distance only; a custom distance screens with ``is_member_approx``).
    ``buckets``, the bucket codes already in int32, saves the relayout."""
    if params.mode != "spec_in" or not default_distance(distance_fn):
        return None
    bl_i32, bc_i32 = (kernel_view(mem) if buckets is None
                      else (mem.blooms, buckets))
    return bl_i32, bc_i32, kernel_filter_params(ctx.qf)


def run_hops(store: RecordStore, codes, mem: InMemory, ctx: QueryCtx,
             st: HopState, n_hops: int, params: SearchParams,
             fetch_fn=local_fetch, distance_fn=None) -> HopState:
    """Advance every query ``n_hops`` hops: settled rows are exact fixed
    points of the hop step, so hopping them changes nothing. Each hop
    consumes the slab fetched at the end of the previous one (the cross-hop
    prefetch). ``st`` is consumed as by :func:`_hop_step`: the returned
    state holds its ``visited`` tensor, updated in place.

    ``fetch_fn`` reads records: :func:`local_fetch` (the device backend)
    gathers them from ``store`` with no host synchronisation; the disk
    tier's callable (``storage/disk.py``) copies each hop's ids to the host
    to read their pages, and in strict_in the gated attribute reads too.
    ``distance_fn`` is :func:`_hop_step`'s.

    On a clean hop (:func:`_graphable`) one hop, the frontier's fetch
    (:func:`_issue`) and :func:`_hop_step`, is captured at the first call
    of its shape and replayed ``n_hops`` times (:class:`_HopGraph`): a few
    launches a hop in place of a few hundred PyTorch calls. The fetch is
    captured where it is a device gather (:func:`local_fetch`); a host
    fetch (``wants_ctx``) is called between two graphs. Every other call
    runs :func:`_run_hops_eager`. Both run the same kernels on the same
    data in the same order, so they agree bit for bit (the eager loop's
    last fetch, which no hop consumes, is not replayed: a chunk of
    ``n_hops`` fetches ``n_hops`` times)."""
    if n_hops > 0 and _graphable(store, codes, st, params, fetch_fn,
                                 distance_fn):
        return _run_graphed(store, codes, mem, ctx, st, n_hops, params,
                            fetch_fn)
    return _run_hops_eager(store, codes, mem, ctx, st, n_hops, params,
                           fetch_fn, distance_fn)


def _run_hops_eager(store: RecordStore, codes, mem: InMemory, ctx: QueryCtx,
                    st: HopState, n_hops: int, params: SearchParams,
                    fetch_fn=local_fetch, distance_fn=None) -> HopState:
    """:func:`run_hops` one PyTorch call at a time: the path of every call
    that is not a clean hop, and the reference the CUDA graphs are held
    to."""
    mc = _mc(mem, ctx, params, distance_fn)
    rec = _issue(store, st, params, fetch_fn)
    for _ in range(n_hops):
        st = _hop_step(store, codes, mem, params, ctx, mc, st, rec,
                       fetch_fn, distance_fn)
        rec = _issue(store, st, params, fetch_fn)
    return st


def _graphable(store: RecordStore, codes, st: HopState,
               params: SearchParams, fetch_fn, distance_fn) -> bool:
    """Whether :func:`run_hops` replays a captured hop: on CUDA tensors of
    a store that keeps hop graphs, with the default distance and no fault
    plan, and with :func:`local_fetch`, or with a host fetch (``wants_ctx``)
    outside strict_in, whose attribute probe is a second host read inside
    the hop step."""
    host_fetch = getattr(fetch_fn, "wants_ctx", False)
    return (store.hop_graphs is not None and codes.is_cuda
            and st.visited.is_cuda
            and (fetch_fn is local_fetch
                 or (host_fetch and params.mode != "strict_in"))
            and default_distance(distance_fn) and params.fault_plan is None)


_capture = threading.local()    # .graph: the _HopGraph this thread captures


def _entry(name: str, *args):
    """``kops.<name>(*args)``: a hand-written kernel entry of the hop step.
    While this thread captures a hop (:meth:`_HopGraph.capture`), the call
    is left out of the graph (:meth:`_HopGraph.hole`) and made from its
    entry at every replay instead."""
    graph = getattr(_capture, "graph", None)
    if graph is None:
        return getattr(kops, name)(*args)
    return graph.hole(name, args)


def _like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _loaded(ctx: QueryCtx, st: HopState, mc) -> tuple:
    """The tensors a hop graph copies in at a chunk's start: the query
    constants, the state and the fused kernel's filter parameters (its
    blooms and bucket words, the in-memory tier's own, are read in
    place)."""
    extra = () if mc is None else tuple(mc[2])
    return (ctx.queries, ctx.tables, *ctx.qf, ctx.merged_tbl, *st) + extra


def _record_fields(store: RecordStore) -> list:
    """``(name, tensor)`` of each record field a fetch returns."""
    return [(f, getattr(store, f)) for f in
            ("vectors", "neighbors", "dense_neighbors", "rec_labels",
             "rec_values", "cand_first") if getattr(store, f) is not None]


def _reads(store: RecordStore, codes, mc) -> tuple:
    """The tensors a hop graph reads in place: the store's, the codes and
    the fused kernel's blooms and bucket words."""
    return (store.vectors, store.neighbors, store.dense_neighbors,
            store.rec_labels, store.rec_values, store.cand_first, codes) + (
                () if mc is None else tuple(mc[:2]))


class _HopGraph:
    """One hop of one shape over static buffers, which :meth:`load` fills
    from a chunk's own tensors: :meth:`step`, captured (:meth:`capture`)
    as CUDA graphs with a hole for each call of a hand-written kernel
    entry and for a host fetch, so ``k`` replays (:meth:`replay`) advance
    ``k`` hops.

    A hole keeps the hand-written kernels ordinary launches: each replay
    calls ``kops.hop_fused_gather`` and ``kops.or_scatter_`` between the
    graphs as the eager loop calls them, so ``kops.LAUNCHES`` counts them
    where they launch, a profiler finds them inside their entry's call,
    and only PyTorch's own kernels are replayed. A host fetch's hole
    (the disk tier's) follows the graph that packs the frontier's ids:
    each replay calls the fetch, which copies them to the host, reads, and
    copies the records into static record buffers, which the next graph
    reads."""

    def __init__(self, store, codes, mem: InMemory, ctx: QueryCtx,
                 st: HopState, mc):
        self.reads = _reads(store, codes, mc)
        self.ctx = QueryCtx(_like(ctx.queries), _like(ctx.tables),
                            QueryFilter(*(_like(t) for t in ctx.qf)),
                            _like(ctx.merged_tbl))
        self.st = HopState(*(_like(t) for t in st))
        self.mc = None if mc is None else (
            mc[0], mc[1], tuple(_like(t) for t in mc[2]))
        self.static = _loaded(self.ctx, self.st, self.mc)
        # the captured hop in order: CUDA graphs, and between them the
        # holes as (entry name, its arguments, the buffers of its results)
        self.parts: list = []
        self.pool = None

    def load(self, ctx: QueryCtx, st: HopState, mc) -> None:
        for s, t in zip(self.static, _loaded(ctx, st, mc)):
            s.copy_(t)

    def step(self, store, codes, mem, params: SearchParams,
             fetch_fn=local_fetch) -> None:
        """One hop on the static buffers."""
        rec = _issue(store, self.st, params, fetch_fn)
        new = _hop_step(store, codes, mem, params, self.ctx, self.mc,
                        self.st, rec, fetch_fn)
        for s, t in zip(self.st, new):
            if t is not s:
                s.copy_(t)

    def capture(self, store, codes, mem, params: SearchParams, pool,
                fetch_fn=local_fetch) -> None:
        """Capture :meth:`step` on a side stream after one eager run of it
        (the warm-up: every kernel module is loaded before the capture).
        Both advance the loaded state, which the caller loads again."""
        self.step(store, codes, mem, params, fetch_fn)
        cur = torch.cuda.current_stream(codes.device)
        side = torch.cuda.Stream(codes.device)
        side.wait_stream(cur)
        self.pool = pool
        with torch.cuda.stream(side):
            self._begin()
            _capture.graph = self
            try:
                self.step(store, codes, mem, params, fetch_fn)
            finally:
                _capture.graph = None
                self.parts[-1].capture_end()
        cur.wait_stream(side)
        trace.count(graph_captures=1)

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        # thread_local: the server captures on its worker thread while
        # other threads may call into CUDA
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.parts.append(graph)

    def hole(self, name: str, args: tuple):
        """End the graph being captured at a call of ``kops.<name>``, or of
        a host fetch (``name`` "fetch", ``args`` :func:`_issue`'s fetch
        callable, store, packed ids and flavour), note the call, and begin
        the next graph. Its arguments stay held, so their buffers stay
        where the graphs read and write them; the fused kernel's results
        and the fetched records get buffers of their own (allocated
        outside the pool), which each replay's call fills. ``or_scatter_``
        works in place and returns its ``words``. The fetch's store is
        held without its graph cache, which holds this graph."""
        self.parts[-1].capture_end()
        if name == "or_scatter_":
            out = args[0]
        elif name == "fetch":
            fetch_fn, store, packed, dense = args
            args = (fetch_fn, store._replace(hop_graphs=None), packed, dense)
            out = {f: torch.empty((packed.shape[1],) + t.shape[1:],
                                  dtype=t.dtype, device=packed.device)
                   for f, t in _record_fields(store)}
        else:
            ids = args[4]
            out = (torch.empty(ids.shape, dtype=torch.float32,
                               device=ids.device),
                   torch.empty(ids.shape, dtype=torch.bool,
                               device=ids.device))
        self.parts.append((name, args, out))
        self._begin()
        return out

    def replay(self) -> None:
        """One captured hop: the graphs in turn, each hole's call made
        between them."""
        for part in self.parts:
            if not isinstance(part, tuple):
                part.replay()
                continue
            name, args, out = part
            if name == "fetch":
                fetch_fn, store, packed, dense = args
                got = fetch_fn(store, packed, dense=dense, out=out)
                pairs = [(out[f], got[f]) for f in out]
            else:
                got = getattr(kops, name)(*args)
                pairs = [] if got is out else zip(out, got)
            for o, g in pairs:
                if g is not o:
                    o.copy_(g)

    def unload(self, visited: torch.Tensor) -> HopState:
        """Fresh tensors of the static state; ``visited``, the chunk's own,
        takes the static words in place, as the eager loop updates it."""
        visited.copy_(self.st.visited)
        return HopState(*(visited if s is self.st.visited else s.clone()
                          for s in self.st))


def _run_graphed(store: RecordStore, codes, mem: InMemory, ctx: QueryCtx,
                 st: HopState, n_hops: int, params: SearchParams,
                 fetch_fn=local_fetch) -> HopState:
    """:func:`run_hops` by replay: the store's :class:`_HopGraph` of this
    shape, captured at its first use, replayed ``n_hops`` times. Graphs
    are keyed on everything that fixes a shape or a branch of the body:
    the mode, pool length, beam width, ``max_hops``, ``l_valid``, whether
    the fused kernel's inputs are set, the fetch callable, and the shape
    and dtype of every tensor loaded (the width B among them); one is
    captured again when a tensor it reads in place is another. The bucket
    codes are put in int32 once for each in-memory tier.

    The graphs of a store share one memory pool. That is safe because the
    pool holds only a hop's scratch: what one graph leaves there for the
    next is read within the same hop, and every other tensor a body makes
    is dropped when its capture ends (the new state is copied into static
    buffers allocated outside the pool), so a replay reads nothing that
    another hop left. And no two uses overlap: each holds the store's lock
    from the first copy in to the last copy out, and its work waits on the
    stream for the end of the previous use's (``done``), whatever stream
    that ran on. The tally counts the hop steps replayed here
    (``hop_steps_graphed``)."""
    cache = store.hop_graphs
    cur = torch.cuda.current_stream(codes.device)
    with cache.lock:
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
            cache.done = torch.cuda.Event()
        cur.wait_event(cache.done)
        if cache.buckets is None or cache.buckets[0] is not mem:
            cache.buckets = (mem, mem.bucket_codes.int())
        mc = _mc(mem, ctx, params, buckets=cache.buckets[1])
        key = (params.mode, params.l_search, params.beam_width,
               params.max_hops, params.l_valid or params.l_search,
               mc is not None, fetch_fn,
               tuple((tuple(t.shape), t.dtype) for t in _loaded(ctx, st, mc)))
        g = cache.graphs.get(key)
        if g is None or any(a is not b for a, b in
                            zip(g.reads, _reads(store, codes, mc))):
            g = _HopGraph(store, codes, mem, ctx, st, mc)
            g.load(ctx, st, mc)
            g.capture(store, codes, mem, params, cache.pool, fetch_fn)
            cache.graphs[key] = g
        g.load(ctx, st, mc)
        for _ in range(n_hops):
            g.replay()
        out = g.unload(st.visited)
        cache.done.record(cur)
    trace.count(hop_steps_graphed=n_hops)
    return out


def _finalize(st: HopState, params: SearchParams) -> SearchResult:
    """Top-k verified-valid by exact distance (once, outside the loop)."""
    final_key = torch.where(st.res_valid, st.res_d, BIG)
    order = _stable_order(final_key, 1)[:, :params.k]
    top_valid = torch.gather(st.res_valid, 1, order)
    out_ids = torch.where(top_valid, torch.gather(st.res_ids, 1, order), -1)
    out_d = torch.where(top_valid, torch.gather(st.res_d, 1, order),
                        float("inf"))
    n_valid = st.res_valid.sum(1, dtype=torch.int32)
    n_explored = (st.res_ids >= 0).sum(1, dtype=torch.int32)
    fp = ((st.res_ids >= 0) & ~st.res_valid).sum(1, dtype=torch.int32)
    c = st.counters
    return SearchResult(out_ids, out_d, c[:, 0], c[:, 3], c[:, 1], c[:, 2],
                        n_valid, fp, n_explored, c[:, 4], c[:, 5], c[:, 6])


def _device_inputs(qfilters, queries, entries, device):
    qf = filter_to_device(qfilters, device)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(device)
    if entries is not None:
        entries = torch.as_tensor(entries, dtype=torch.int32).to(device)
    return qf, queries, entries


def init_search(store, codes, codebook, mem, qfilters, queries, entry,
                params: SearchParams, entries=None, distance_fn=None):
    """``(QueryCtx, HopState)`` for a batch — the seeding half of
    :func:`filtered_search`."""
    qf, queries, entries = _device_inputs(qfilters, queries, entries,
                                          codes.device)
    return _init(store, codes, codebook, mem, qf, queries, entry, params,
                 entries, distance_fn)


def finalize_search(st: HopState, params: SearchParams) -> SearchResult:
    return _finalize(st, params)


def filtered_search(store: RecordStore, codes, codebook, mem: InMemory,
                    qfilters: QueryFilter, queries, entry: int,
                    params: SearchParams, entries=None,
                    distance_fn=None, fetch_fn=local_fetch) -> SearchResult:
    """Single-shot search: every query hops until the whole batch settles
    (the oracle of the pipelined driver's compaction). ``distance_fn``
    (``distance_fn(codes (S, M), table (M, K)) -> (S,)``, see
    :func:`row_distance`) replaces the default ADC distance everywhere."""
    ctx, st = init_search(store, codes, codebook, mem, qfilters, queries,
                          entry, params, entries, distance_fn)
    mc = _mc(mem, ctx, params, distance_fn)
    rec = _issue(store, st, params, fetch_fn)
    steps = 0
    for _ in range(params.max_hops):
        if not bool(st.active.any()):
            break
        st = _hop_step(store, codes, mem, params, ctx, mc, st, rec,
                       fetch_fn, distance_fn)
        rec = _issue(store, st, params, fetch_fn)
        steps += 1
    trace.count(hop_steps=steps,
                row_hops_dispatched=steps * st.active.shape[0])
    return _finalize(st, params)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


class _MaskReader:
    """Reads an active mask back to the host without blocking the device:
    on the card a non-blocking copy into pinned memory behind an event, read
    once the event has completed; on the CPU a plain copy."""

    def __init__(self, mask: torch.Tensor):
        m = mask.to(torch.int8)
        if m.is_cuda:
            self._host = torch.empty(m.shape, dtype=torch.int8,
                                     pin_memory=True)
            self._host.copy_(m, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = m.clone(), None

    def read(self) -> np.ndarray:
        with trace.span("search.readback"):
            if self._event is not None:
                trace.sync(self._event)
            return self._host.numpy().astype(bool)


def filtered_search_pipelined(store: RecordStore, codes, codebook,
                              mem: InMemory, qfilters: QueryFilter, queries,
                              entry: int, params: SearchParams, entries=None,
                              hop_chunk: int = DEFAULT_HOP_CHUNK,
                              min_bucket: int = MIN_COMPACT_BUCKET,
                              async_readback: bool = True,
                              distance_fn=None, fetch_fn=local_fetch,
                              collect_trace: bool = False, runner=None):
    """Bucketed host driver: chunked hops + straggler compaction.

    Runs :func:`run_hops` ``hop_chunk`` hops at a time; after every chunk
    the still-active queries are counted on the host and, when they fit a
    smaller power-of-two bucket (≥ ``min_bucket``), compacted into it —
    settled rows fold back into the full-width state, pads (repeats of a
    live row, forced inactive) fill the bucket. No hop mixes rows, so every
    query's trajectory equals the single-shot :func:`filtered_search`.

    With ``async_readback`` the driver issues the next chunk before reading
    the previous chunk's active mask, so decisions run one chunk late on a
    stale mask — a superset of the truly active rows, and inactive rows are
    exact fixed points. ``hop_chunk=0`` runs the single-shot search.
    ``fetch_fn`` and ``distance_fn`` are :func:`run_hops`'s.

    With ``collect_trace=True`` returns ``(SearchResult, trace)``, the trace
    one ``{"hop", "active", "bucket"}`` entry per observed chunk boundary:
    the hops dispatched so far, the active rows counted and the working
    width (with the async readback the observations lag dispatch by one
    chunk); ``hop_chunk=0`` gives an empty trace.

    ``runner`` (a ``distributed.ShardedSearchRunner``) replaces
    :func:`run_hops` with its sharded hop over the sharded record store
    (``fetch_fn`` is then the runner's and ignored here); seeding,
    compaction and finalisation run here unchanged. ``min_bucket`` is raised
    to ``runner.n_shards`` so every bucket (a power of two, as the shard
    count is) splits evenly, and ``hop_chunk=0`` becomes one ``max_hops``
    chunk through the runner. Results equal the single-device driver's.
    """
    if runner is not None:
        min_bucket = max(min_bucket, runner.n_shards)
        if hop_chunk <= 0:
            hop_chunk = params.max_hops
    if hop_chunk <= 0:
        res = filtered_search(store, codes, codebook, mem, qfilters, queries,
                              entry, params, entries=entries,
                              distance_fn=distance_fn, fetch_fn=fetch_fn)
        return (res, []) if collect_trace else res
    queries = np.asarray(queries, np.float32)
    orig_b = int(queries.shape[0])
    B = max(min_bucket, _pow2_at_least(orig_b))
    n_pad = B - orig_b
    if n_pad:
        def _pad(a):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.broadcast_to(a[:1], (n_pad,) + a.shape[1:])], axis=0)
        queries = _pad(queries)
        qfilters = QueryFilter(*(_pad(x) for x in qfilters))
        if entries is not None:
            entries = _pad(entries)
    dev = codes.device
    with trace.span("search.seed", rows=B):
        full_ctx, full_st = init_search(store, codes, codebook, mem,
                                        qfilters, queries, entry, params,
                                        entries=entries,
                                        distance_fn=distance_fn)
        if n_pad:
            act0 = full_st.active.clone()
            act0[orig_b:] = False
            full_st = full_st._replace(active=act0)
    work_ctx, work_st = full_ctx, full_st
    work_map: np.ndarray | None = None   # None ⇒ identity (full width)
    work_valid: np.ndarray | None = None  # non-pad rows of the bucket
    width = B
    hops_done = 0
    chunk_log: list = []

    def hop(ctx, st):
        # the one count of dispatched chunks: the chunk log's hops and the
        # tally's hop steps and row-hops
        nonlocal hops_done
        hops_done += hop_chunk
        trace.count(hop_steps=hop_chunk,
                    row_hops_dispatched=width * hop_chunk)
        with trace.span("search.hops", width=width, hops=hop_chunk):
            if runner is not None:
                st, active = runner.run(ctx, st, hop_chunk, params,
                                        distance_fn)
            else:
                st = run_hops(store, codes, mem, ctx, st, hop_chunk, params,
                              fetch_fn, distance_fn)
                active = st.active
            return st, _MaskReader(active)

    act = _MaskReader(work_st.active).read()
    inflight = None                      # mask reader of the newest chunk
    while True:
        n_act = int(act.sum())
        if collect_trace:
            chunk_log.append({"hop": hops_done, "active": n_act,
                              "bucket": width})
        bucket = min(B, max(min_bucket, _pow2_at_least(max(n_act, 1))))
        if n_act and bucket >= width:
            work_st, mask = hop(work_ctx, work_st)
            if not async_readback:
                act = mask.read()
                continue
            if inflight is None:
                # prime the one-chunk pipeline: issue a second chunk so the
                # device has work while the first mask comes back
                work_st, inflight = hop(work_ctx, work_st)
                act = mask.read()
            else:
                act, inflight = inflight.read(), mask
            continue
        # settle or shrink: fold the working rows into the full state
        with trace.span("search.compact", rows=n_act, width=bucket):
            if work_map is None:
                full_st = work_st
            else:
                full_st = put_rows(full_st, work_st,
                                   torch.from_numpy(work_map).long().to(dev),
                                   torch.from_numpy(work_valid).to(dev))
            if n_act == 0:
                break
            surv = np.flatnonzero(act)
            idx = (work_map[surv] if work_map is not None else surv) \
                .astype(np.int64)
            pads = np.full(bucket - idx.size, idx[0], np.int64)
            work_map = np.concatenate([idx, pads])
            work_valid = np.arange(bucket) < idx.size
            gidx = torch.from_numpy(work_map).to(dev)
            work_ctx = take_rows(full_ctx, gidx)
            work_st = take_rows(full_st, gidx)
            work_st = work_st._replace(
                active=work_st.active & torch.from_numpy(work_valid).to(dev))
        width = bucket
        inflight = None
        if async_readback:
            # every carried row was stale-active: assume all live and issue
            # the next chunk at this width
            act = work_valid.copy()
            continue
        work_st, mask = hop(work_ctx, work_st)
        act = mask.read()
    with trace.span("search.finalize"):
        res = finalize_search(full_st, params)
    if n_pad:
        res = SearchResult(*(a[:orig_b] for a in res))
    return (res, chunk_log) if collect_trace else res


# ---------------------------------------------------------------------------
# Naive oracles (same semantics, naive primitives): the A/B reference and
# the pre-fused baseline
# ---------------------------------------------------------------------------

def _exact_sq_dist(vecs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact squared distances of vecs (B, W, D) to queries q (B, D)."""
    return sq_dist(vecs, q[:, None, :])


class _NaiveState(NamedTuple):
    """One query per row of the naive oracles' state (leading dim B)."""
    pool_ids: torch.Tensor    # (B, P) int32, key-ascending
    pool_key: torch.Tensor    # (B, P) float32
    explored: torch.Tensor    # (B, P) bool
    seen: torch.Tensor        # (B, N + 1) bool ever-admitted ids (the last
                              # column is the drop slot); (B, 0) in legacy
    res_ids: torch.Tensor     # (B, res_cap) int32 explored, in hop order
    res_d: torch.Tensor       # (B, res_cap) float32 exact distances
    res_valid: torch.Tensor   # (B, res_cap) bool exact membership
    counters: torch.Tensor    # (B, 4) int32: io, dist_comps, approx, hops


class _NaiveCtx(NamedTuple):
    queries: torch.Tensor     # (B, D)
    tables: torch.Tensor      # (B, M, K)
    qf: QueryFilter


def _naive_init(codes, codebook, mem, qfilters, queries, entry, params,
                entries, distance_fn, legacy: bool):
    p = params
    P = p.l_search
    res_cap = p.max_hops * p.beam_width
    n_ids = codes.shape[0]
    qf, queries, entries = _device_inputs(qfilters, queries, entries,
                                          codes.device)
    B = queries.shape[0]
    dev = queries.device
    if entries is None:
        entries = torch.full((B, 1), int(entry), dtype=torch.int32,
                             device=dev)
    E = entries.shape[1]
    tables = pq_mod.distance_table(codebook, queries)
    ent_valid = entries >= 0
    safe_ent = torch.where(ent_valid, entries, 0)
    entry_d = row_distance(distance_fn, codes[safe_ent.long()], tables)
    entry_ok = is_member_approx(qf, safe_ent, mem) & ent_valid
    entry_key = torch.where(
        ent_valid, entry_d + torch.where(entry_ok, 0.0, INVALID_PENALTY),
        BIG)
    pool_ids = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    pool_ids[:, :E] = torch.where(ent_valid, entries, -1)
    pool_key = torch.full((B, P), BIG, dtype=torch.float32, device=dev)
    pool_key[:, :E] = entry_key
    explored = torch.ones((B, P), dtype=torch.bool, device=dev)
    explored[:, :E] = ~ent_valid
    if legacy:
        seen = torch.zeros((B, 0), dtype=torch.bool, device=dev)
    else:
        seen = torch.zeros((B, n_ids + 1), dtype=torch.bool, device=dev)
        seen.scatter_(1, torch.where(ent_valid, safe_ent, n_ids).long(),
                      True)
    st = _NaiveState(
        pool_ids, pool_key, explored, seen,
        torch.full((B, res_cap), -1, dtype=torch.int32, device=dev),
        torch.full((B, res_cap), BIG, dtype=torch.float32, device=dev),
        torch.zeros((B, res_cap), dtype=torch.bool, device=dev),
        torch.zeros((B, 4), dtype=torch.int32, device=dev))
    return _NaiveCtx(queries, tables, qf), st


def _naive_running(st: _NaiveState, params: SearchParams) -> torch.Tensor:
    """Each row's loop condition: hops left, a frontier, and not settled —
    the settled test re-sorts the row's whole explored buffer (the naive
    form of the fused path's incremental bound)."""
    l_valid = params.l_valid or params.l_search
    res_cap = st.res_d.shape[1]
    frontier = (~st.explored & (st.pool_key < BIG)).any(1)
    n_ok = st.res_valid.sum(1)
    kth = torch.sort(torch.where(st.res_valid, st.res_d, BIG), dim=1,
                     stable=True).values[:, min(l_valid, res_cap) - 1]
    best_unexp = torch.where(st.explored, BIG, st.pool_key).min(1).values
    settled = (n_ok >= l_valid) & (best_unexp > kth)
    return (st.counters[:, 3] < params.max_hops) & frontier & ~settled


def _naive_hop(store, codes, mem, params, ctx: _NaiveCtx, st: _NaiveState,
               run: torch.Tensor, distance_fn, fetch_fn,
               legacy: bool) -> _NaiveState:
    """One iteration of every row's loop; rows with ``run`` False keep
    their state (the rows of ``repro``'s vmapped ``while_loop`` whose
    condition failed). The oracle dedups against its exact ever-admitted
    ``seen`` set and first occurrence in the slab; ``legacy`` instead
    broadcasts every candidate against the pool, the explored buffer and
    its own row, then the selected ids against each other."""
    p = params
    P, W = p.l_search, p.beam_width
    R = store.degree
    Rd = store.dense_degree if p.mode == "spec_in" else 0
    C = R + Rd
    rec_pages = store.pages_dense if p.mode == "spec_in" else store.pages_std
    n_ids = codes.shape[0]
    queries, tables, qf = ctx
    B, D = queries.shape
    dev = queries.device
    (pool_ids, pool_key, explored, seen, res_ids, res_d, res_valid,
     counters) = st
    hops = counters[:, 3]
    keep = run[:, None]

    # ---- 1. pick best-W unexplored (by priority key) ----
    masked = torch.where(explored, BIG, pool_key)
    sel = torch.sort(masked, dim=1, stable=True).indices[:, :W]
    cur_ids = torch.gather(pool_ids, 1, sel)
    cur_live = torch.gather(masked, 1, sel) < BIG
    explored = explored.scatter(1, sel, True)
    safe_cur = torch.where(cur_live, cur_ids, 0)

    # ---- 2. fetch records (vector + neighbors + attrs: one I/O) ----
    rec = fetch_fn(store, safe_cur.reshape(-1))
    vecs = rec["vectors"].reshape(B, W, D)
    nbrs = rec["neighbors"].reshape(B, W, R)
    rl = rec["rec_labels"].reshape(B, W, -1)
    rv = rec["rec_values"].reshape(B, W, -1)
    io = counters[:, 0] + cur_live.sum(1, dtype=torch.int32) * rec_pages

    # ---- 3. re-rank + piggybacked exact verification ----
    ex_d = torch.where(cur_live, _exact_sq_dist(vecs, queries), BIG)
    ex_ok = is_member(qf, rl, rv) & cur_live
    start = torch.where(run, hops, 0).long()[:, None] * W
    pos = start + torch.arange(W, device=dev)[None, :]
    res_ids = torch.where(keep, res_ids.scatter(
        1, pos, torch.where(cur_live, cur_ids, -1)), res_ids)
    res_d = torch.where(keep, res_d.scatter(1, pos, ex_d), res_d)
    res_valid = torch.where(keep, res_valid.scatter(1, pos, ex_ok),
                            res_valid)

    # ---- 4. candidate generation per mode ----
    if p.mode == "spec_in":
        cand = torch.cat([nbrs, rec["dense_neighbors"].reshape(B, W, Rd)],
                         dim=2)                                # (B, W, C)
    else:
        cand = nbrs
    is_direct = torch.arange(C, device=dev) < R
    cand = torch.where(cur_live[:, :, None], cand, -1)
    live = cand >= 0
    safe_cand = torch.where(live, cand, 0)
    if legacy:
        dup_pool = (cand[..., None] == pool_ids[:, None, None, :]).any(-1)
        dup_res = (cand[..., None] == res_ids[:, None, None, :]).any(-1)
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev),
                         -1)
        dup_row = ((cand[..., :, None] == cand[..., None, :]) & tri).any(-1)
        fresh = live & ~dup_pool & ~dup_res & ~dup_row
    else:
        first = _first_occurrence(cand.reshape(B, W * C),
                                  live.reshape(B, W * C),
                                  n_ids).reshape(B, W, C)
        was_seen = torch.gather(seen, 1, safe_cand.reshape(B, -1).long())
        fresh = live & ~was_seen.reshape(B, W, C) & first

    approx = counters[:, 2]
    if p.mode == "post":
        ok = fresh
    elif p.mode == "spec_in":
        ok = is_member_approx(qf, safe_cand.reshape(B, W * C),
                              mem).reshape(B, W, C) & fresh
        approx = approx + live.sum((1, 2), dtype=torch.int32)
    else:  # strict_in: read every fresh neighbor's attrs from "SSD"
        nrec = fetch_fn(store, safe_cand.reshape(-1))
        n_rl = nrec["rec_labels"].reshape(B, W * C, -1)
        n_rv = nrec["rec_values"].reshape(B, W * C, store.n_fields)
        ok = is_member(qf, n_rl, n_rv).reshape(B, W, C) & fresh
        io = io + fresh.sum((1, 2), dtype=torch.int32)        # 1 page / nbr

    # ---- 5. slot selection: up to R approx-valid, bridge back-fill ----
    if p.mode == "spec_in":
        rank_ok = torch.cumsum(ok.int(), dim=2) - 1
        fill = fresh & ~ok & is_direct
        rank_fill = torch.cumsum(fill.int(), dim=2) - 1
        n_ok_row = ok.sum(2, keepdim=True)
        order_key = torch.where(
            ok, rank_ok.float(),
            torch.where(fill, (n_ok_row + rank_fill).float(), BIG))
        take = torch.sort(order_key, dim=2, stable=True).indices[..., :R]
        sel_ids = torch.gather(cand, 2, take)
        sel_ok = torch.gather(ok, 2, take)
        sel_live = sel_ok | torch.gather(fill, 2, take)
    else:
        sel_ids, sel_ok, sel_live = cand, ok, ok

    # ---- 6. PQ distances for the selected candidates (unfused) ----
    flat_ids = sel_ids.reshape(B, -1)
    flat_live = sel_live.reshape(B, -1)
    flat_ok = sel_ok.reshape(B, -1)
    if legacy:
        # cross-row dedup of the selected set (W > 1 beams may collide)
        nf = flat_ids.shape[1]
        trif = torch.tril(torch.ones((nf, nf), dtype=torch.bool,
                                     device=dev), -1)
        dupf = ((flat_ids[:, :, None] == flat_ids[:, None, :])
                & trif).any(-1)
        flat_live = flat_live & ~dupf
        flat_ok = flat_ok & ~dupf
    pq_d = row_distance(distance_fn,
                        codes[torch.where(flat_live, flat_ids, 0).long()],
                        tables)
    key = pq_d + torch.where(flat_ok, 0.0, INVALID_PENALTY)
    key = torch.where(flat_live, key, BIG)
    dist_comps = counters[:, 1] + flat_live.sum(1, dtype=torch.int32)
    if not legacy:
        seen.scatter_(1, torch.where(flat_live & keep, flat_ids,
                                     n_ids).long(), True)

    # ---- 7. merge into the pool (full stable argsort) ----
    all_ids = torch.cat([pool_ids, torch.where(flat_live, flat_ids, -1)], 1)
    all_key = torch.cat([pool_key, key], 1)
    all_exp = torch.cat([explored, torch.zeros_like(flat_live)], 1)
    order = torch.sort(all_key, dim=1, stable=True).indices[:, :P]
    counters_new = torch.stack([io, dist_comps, approx, hops + 1], 1).int()
    return _NaiveState(
        torch.where(keep, torch.gather(all_ids, 1, order), st.pool_ids),
        torch.where(keep, torch.gather(all_key, 1, order), st.pool_key),
        torch.where(keep, torch.gather(all_exp, 1, order), st.explored),
        seen, res_ids, res_d, res_valid,
        torch.where(keep, counters_new, counters))


def _naive_result(st: _NaiveState, params: SearchParams) -> SearchResult:
    """Top-k verified-valid by exact distance; the oracles draw no faults,
    so their fault counters are zero."""
    final_key = torch.where(st.res_valid, st.res_d, BIG)
    order = torch.sort(final_key, dim=1, stable=True).indices[:, :params.k]
    top_valid = torch.gather(st.res_valid, 1, order)
    out_ids = torch.where(top_valid, torch.gather(st.res_ids, 1, order), -1)
    out_d = torch.where(top_valid, torch.gather(st.res_d, 1, order),
                        float("inf"))
    c = st.counters
    zero = torch.zeros_like(c[:, 0])
    return SearchResult(
        out_ids, out_d, c[:, 0], c[:, 3], c[:, 1], c[:, 2],
        st.res_valid.sum(1, dtype=torch.int32),
        ((st.res_ids >= 0) & ~st.res_valid).sum(1, dtype=torch.int32),
        (st.res_ids >= 0).sum(1, dtype=torch.int32), zero, zero, zero)


def _naive_search(store, codes, codebook, mem, qfilters, queries, entry,
                  params, entries, distance_fn, fetch_fn,
                  legacy: bool) -> SearchResult:
    ctx, st = _naive_init(codes, codebook, mem, qfilters, queries, entry,
                          params, entries, distance_fn, legacy)
    while True:
        run = _naive_running(st, params)
        if not bool(run.any()):
            break
        st = _naive_hop(store, codes, mem, params, ctx, st, run,
                        distance_fn, fetch_fn, legacy)
    return _naive_result(st, params)


def filtered_search_ref(store: RecordStore, codes, codebook, mem: InMemory,
                        qfilters: QueryFilter, queries, entry: int,
                        params: SearchParams, entries=None,
                        distance_fn=None,
                        fetch_fn=local_fetch) -> SearchResult:
    """The A/B oracle for :func:`filtered_search` (``repro``'s
    ``filtered_search_ref``, with the whole batch as the leading dimension
    where ``repro`` vmaps over queries).

    Same hop semantics — an *exact* ever-admitted visited set, the same
    admission keys and early termination — with the naive primitives the
    fused path replaces: a (B, N) ``seen`` set, first occurrence inside
    the slab, a full stable argsort pool merge, a full re-sort of each
    row's explored buffer in its loop condition, separate unfused distance
    (``distance_fn``, :func:`row_distance`) and membership gathers, and
    strict_in reading every neighbour's attributes through ``fetch_fn``
    (the plain ``fetch_fn(store, ids)`` contract). A row whose condition
    fails keeps its state while the others hop. It shares nothing with
    the fused hop step but ``is_member``, ``is_member_approx``,
    ``distance_table``, the distance function (``distance_fn`` or
    ``pq.adc_lookup``) and the fetch. Parity bar: identical
    ``io_pages``/``explored``/``hops``/``n_valid`` while the visited set is
    exact (n_ids <= 2**20), recall within 1%. No fault plan: its fault
    counters are zero."""
    return _naive_search(store, codes, codebook, mem, qfilters, queries,
                         entry, params, entries, distance_fn, fetch_fn,
                         legacy=False)


def filtered_search_legacy(store: RecordStore, codes, codebook,
                           mem: InMemory, qfilters: QueryFilter, queries,
                           entry: int, params: SearchParams, entries=None,
                           distance_fn=None,
                           fetch_fn=local_fetch) -> SearchResult:
    """The pre-fused-pipeline search (``repro``'s
    ``filtered_search_legacy``), the baseline the benchmarks measure
    against, in the same batched naive form as :func:`filtered_search_ref`.
    Its hop does quadratic work: pairwise dedup broadcasts against the pool
    and the whole explored buffer, a full argsort merge, and a full
    explored-buffer re-sort in the loop condition. Its dedup differs from
    the fused path's (a candidate dropped from the pool may be re-proposed),
    so its counters compare with ``repro``'s legacy only — use
    :func:`filtered_search_ref` for A/B parity."""
    return _naive_search(store, codes, codebook, mem, qfilters, queries,
                         entry, params, entries, distance_fn, fetch_fn,
                         legacy=True)

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

Execution: :func:`run_hops` advances a batch ``n_hops`` hops with no host
synchronisation inside on the device backend (rows that settled are exact
fixed points of the hop step, so running a whole chunk changes nothing for
them); every driver takes a ``fetch_fn``, the disk tier's included
(``storage/disk.py``: one host copy of the ids a hop);
:func:`filtered_search_pipelined` reads the active mask back one chunk late
(a non-blocking copy into pinned memory behind a CUDA event) and compacts
surviving queries into power-of-two buckets — bit-identical to the
single-shot :func:`filtered_search`.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.kernels.ref import BIG, INVALID_PENALTY, adc_slab_ref, \
    sq_dist, visited_slot, visited_spec

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


def _slab_pq(codes: torch.Tensor, ids: torch.Tensor,
             tables: torch.Tensor) -> torch.Tensor:
    """ADC distances of a gathered candidate slab: codes (N, M), ids (B, S),
    tables (B, M, K) -> (B, S)."""
    return adc_slab_ref(codes[ids.long()], tables)


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


def _init(store, codes, codebook, mem, qf, queries, entry, params, entries):
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
    entry_d = _slab_pq(codes, safe_ent, tables)              # (B, E)
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
              fetch_fn=local_fetch) -> HopState:
    """Consume the in-flight record slab for one hop, merge, and select the
    next frontier (the step numbering follows ``repro``'s ``_hop_step``).
    ``st`` is consumed: its ``visited`` words are updated in place and
    returned in the new state (see :class:`HopState`). ``fetch_fn`` reads
    the strict_in neighbours' attributes (see :func:`run_hops`)."""
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

    # ---- 2'. the carried slab ----
    vecs = rec["vectors"].reshape(B, W, D)
    nbrs = rec["neighbors"].reshape(B, W, R)
    rl = rec["rec_labels"].reshape(B, W, -1)
    rv = rec["rec_values"].reshape(B, W, -1)
    io = counters[:, 0] + cur_live.sum(1, dtype=torch.int32) * rec_pages

    # ---- 2''. fault ladder on the slab read (core/faults.py) ----
    # Retry → hedge → degrade. Every draw is a stateless hash of (record
    # id, that query's own hop counter, attempt), so compaction can gather
    # rows in any order and no draw changes. Rows whose every attempt drew
    # bad are "degraded".
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
        io = io + n_retries * rec_pages          # each retry re-reads pages

    # ---- 3. re-rank + piggybacked exact verification ----
    ex_d = torch.where(cur_live, sq_dist(vecs, queries[:, None, :]), BIG)
    ex_ok = is_member(qf, rl, rv) & cur_live
    if degraded_rows is not None:
        # a degraded row never saw its record: its ADC distance and approx
        # membership (a no-false-negative superset) stand in for it
        deg_d = torch.where(cur_live, _slab_pq(codes, ids_safe, tables), BIG)
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
        key_slab = _slab_pq(codes, safe_cand, tables)
        approx_c = counters[:, 2]
    elif p.mode == "spec_in":
        bl_i32, bc_i32, (f_scal, f_om, f_rf, f_blo, f_bhi) = mc
        # the kernel gathers each candidate's code row, bloom word, bucket
        # words and rare-list bit itself
        key_slab, ok_approx = kops.hop_fused_gather(
            codes, bl_i32, bc_i32, merged_tbl, safe_cand, tables, f_scal,
            f_om, f_rf, f_blo, f_bhi)
        ok = ok_approx & fresh
        approx_c = counters[:, 2] + live.sum(1, dtype=torch.int32)
    else:  # strict_in: read every fresh neighbor's attributes from "SSD"
        if getattr(fetch_fn, "wants_ctx", False):
            # disk tier: the device-resident bloom/bucket words gate the
            # attribute reads BEFORE any page is read (the paper's saved
            # I/O). The gate is a no-false-negative superset, so a gated-out
            # row's poisoned attributes (labels -1, values NaN) fail exact
            # membership exactly where its real attributes would
            gate = is_member_approx(qf, safe_cand, mem)
            nrec = fetch_fn(store, safe_cand.reshape(-1),
                            need=fresh.reshape(-1), gate=gate.reshape(-1),
                            attrs_only=True)
        else:
            nrec = fetch_fn(store, safe_cand.reshape(-1))
        n_rl = nrec["rec_labels"].reshape(B, W * C, -1)
        n_rv = nrec["rec_values"].reshape(B, W * C, store.n_fields)
        ok = is_member(qf, n_rl, n_rv) & fresh
        io = io + fresh.sum(1, dtype=torch.int32)          # 1 page / neighbor
        key_slab = _slab_pq(codes, safe_cand, tables)
        approx_c = counters[:, 2]

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
    # mark *admitted* candidates visited (a fresh candidate that loses slot
    # selection stays unmarked and may be re-proposed by another parent):
    # new_ids is -1 wherever sel_live is False, and the in-place entry drops
    # those; the state's visited words are updated where they lie
    visited = kops.or_scatter_(visited, new_ids, n_ids)

    # ---- 7. sorted-pool merge: concatenate + one stable sort ----
    all_key = torch.cat([pool_key, new_key], 1)
    srt, midx = torch.sort(all_key, dim=1, stable=True)
    midx = midx[:, :P]
    pool_key = srt[:, :P]
    pool_ids = torch.gather(torch.cat([pool_ids, new_ids], 1), 1, midx)
    pool_exp = torch.gather(
        torch.cat([pool_exp, torch.zeros_like(sel_live)], 1), 1, midx)

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
    (the disk tier's, ``storage/disk.py``) also receives each row's hop
    counter as it stands at issue (its fault draws key on the same
    (id, hop) pairs as the hop step's ladder), the rows' liveness (dead
    rows read nothing) and the record flavour (dense in spec_in)."""
    ids = torch.where(st.cur_live, st.cur_ids, 0).reshape(-1)
    if getattr(fetch_fn, "wants_ctx", False):
        return fetch_fn(store, ids,
                        hops=st.counters[:, 3].repeat_interleave(
                            params.beam_width),
                        live=st.cur_live.reshape(-1),
                        dense=params.mode == "spec_in")
    return fetch_fn(store, ids)


def _mc(mem: InMemory, ctx: QueryCtx, params: SearchParams):
    """The fused kernel's per-call inputs (spec_in only)."""
    if params.mode != "spec_in":
        return None
    bl_i32, bc_i32 = kernel_view(mem)
    return bl_i32, bc_i32, kernel_filter_params(ctx.qf)


def run_hops(store: RecordStore, codes, mem: InMemory, ctx: QueryCtx,
             st: HopState, n_hops: int, params: SearchParams,
             fetch_fn=local_fetch) -> HopState:
    """Advance every query ``n_hops`` hops: settled rows are exact fixed
    points of the hop step, so hopping them changes nothing. Each hop
    consumes the slab fetched at the end of the previous one (the cross-hop
    prefetch). ``st`` is consumed as by :func:`_hop_step`: the returned
    state holds its ``visited`` tensor, updated in place.

    ``fetch_fn`` reads records: :func:`local_fetch` (the device backend)
    gathers them from ``store`` with no host synchronisation; the disk
    tier's callable (``storage/disk.py``) copies each hop's ids to the host
    to read their pages, and in strict_in the gated attribute reads too."""
    mc = _mc(mem, ctx, params)
    rec = _issue(store, st, params, fetch_fn)
    for _ in range(n_hops):
        st = _hop_step(store, codes, mem, params, ctx, mc, st, rec,
                       fetch_fn)
        rec = _issue(store, st, params, fetch_fn)
    return st


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


def check_distance_fn(distance_fn) -> None:
    """The port searches with the default ADC distance only."""
    if distance_fn is not None:
        raise NotImplementedError(
            "distance_fn: custom distances arrive with the reference "
            "oracles, a later slice of the port (ROADMAP queue A, item 8)")


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
    check_distance_fn(distance_fn)
    qf, queries, entries = _device_inputs(qfilters, queries, entries,
                                          codes.device)
    return _init(store, codes, codebook, mem, qf, queries, entry, params,
                 entries)


def finalize_search(st: HopState, params: SearchParams) -> SearchResult:
    return _finalize(st, params)


def filtered_search(store: RecordStore, codes, codebook, mem: InMemory,
                    qfilters: QueryFilter, queries, entry: int,
                    params: SearchParams, entries=None,
                    distance_fn=None, fetch_fn=local_fetch) -> SearchResult:
    """Single-shot search: every query hops until the whole batch settles
    (the oracle of the pipelined driver's compaction)."""
    check_distance_fn(distance_fn)
    ctx, st = init_search(store, codes, codebook, mem, qfilters, queries,
                          entry, params, entries)
    mc = _mc(mem, ctx, params)
    rec = _issue(store, st, params, fetch_fn)
    for _ in range(params.max_hops):
        if not bool(st.active.any()):
            break
        st = _hop_step(store, codes, mem, params, ctx, mc, st, rec,
                       fetch_fn)
        rec = _issue(store, st, params, fetch_fn)
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
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().astype(bool)


def filtered_search_pipelined(store: RecordStore, codes, codebook,
                              mem: InMemory, qfilters: QueryFilter, queries,
                              entry: int, params: SearchParams, entries=None,
                              hop_chunk: int = DEFAULT_HOP_CHUNK,
                              min_bucket: int = MIN_COMPACT_BUCKET,
                              async_readback: bool = True,
                              distance_fn=None, fetch_fn=local_fetch):
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
    ``fetch_fn`` is :func:`run_hops`'s.
    """
    check_distance_fn(distance_fn)
    if hop_chunk <= 0:
        return filtered_search(store, codes, codebook, mem, qfilters,
                               queries, entry, params, entries=entries,
                               fetch_fn=fetch_fn)
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
    full_ctx, full_st = init_search(store, codes, codebook, mem, qfilters,
                                    queries, entry, params, entries=entries)
    if n_pad:
        act0 = full_st.active.clone()
        act0[orig_b:] = False
        full_st = full_st._replace(active=act0)
    work_ctx, work_st = full_ctx, full_st
    work_map: np.ndarray | None = None   # None ⇒ identity (full width)
    work_valid: np.ndarray | None = None  # non-pad rows of the bucket
    width = B

    def hop(ctx, st):
        st = run_hops(store, codes, mem, ctx, st, hop_chunk, params,
                      fetch_fn)
        return st, _MaskReader(st.active)

    act = _MaskReader(work_st.active).read()
    inflight = None                      # mask reader of the newest chunk
    while True:
        n_act = int(act.sum())
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
    res = finalize_search(full_st, params)
    if n_pad:
        res = SearchResult(*(a[:orig_b] for a in res))
    return res

"""Speculative pre-filtering (paper §3 Fig. 3a): attribute-index scan →
in-memory PQ brute force over the superset → exact re-rank + verification;
and the serve tier's gated full-corpus scan (:func:`scan_all_gated`).

Counterpart of ``repro.core.prefilter``. The superset comes from
``Selector.pre_filter_approx`` (host side, pages accounted). ``repro`` scans
it in fixed-size chunks carrying a running top-(L+δ) with ``lax.top_k``;
that running merge keeps, among equal distances, the earlier candidate, so
it equals one stable sort of all candidate distances — which is what the
port computes, on the device, in one pass. Both scans compute their ADC
distances with the ``pq_scan`` kernel: the pre route through its gathered
entry (``kernels.ops.pq_scan_gather``, which reads the candidates' code
rows itself), the gated scan through its slab entry (``ops.pq_scan``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import pq as pq_mod
from repro_torch.core import search
from repro_torch.core.records import RecordStore
from repro_torch.core.selectors import (InMemory, QueryFilter, Selector,
                                        filter_to_device, is_member,
                                        is_member_approx)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG, INVALID_PENALTY, sq_dist
from repro_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class PrefilterParams:
    l_rerank: int            # L + δ: vectors fetched from SSD for re-ranking
    k: int = 10
    max_candidates: int = 1 << 20   # superset hard cap


class PrefilterResult(NamedTuple):
    ids: torch.Tensor        # (B, k) verified-valid top-k (-1 pad)
    dists: torch.Tensor      # (B, k)
    io_pages: torch.Tensor   # (B,) scan + re-rank pages
    dist_comps: torch.Tensor  # (B,)
    n_valid: torch.Tensor    # (B,)


def _pq_topl(codes, codebook, query, cand_ids: torch.Tensor, l_rerank: int,
             distance_fn=None):
    """Top-``l_rerank`` of the candidates by ADC distance, ties to the
    earlier candidate; (-1, BIG) pads when there are fewer. Returns
    (top_ids (l,), top_dists (l,)). A custom ``distance_fn(codes (S, M),
    table (M, K)) -> (S,)`` scores the gathered code rows instead of the
    gathered ``pq_scan`` entry."""
    table = pq_mod.distance_table(codebook, query)
    if search.default_distance(distance_fn):
        d = ops.pq_scan_gather(codes, cand_ids, table)
    else:
        d = distance_fn(codes[cand_ids.long()], table)
    return _stable_topl(cand_ids, d, l_rerank)


def _stable_topl(ids: torch.Tensor, keys: torch.Tensor, l_rerank: int):
    """The first ``l_rerank`` of ``(ids, keys)`` in a stable sort by key
    (ties to the earlier entry), padded with (-1, BIG) when there are
    fewer: what ``repro``'s running ``lax.top_k`` merge over chunks
    returns, its init entries (-1, BIG) ahead of any later BIG key."""
    order = torch.sort(keys, stable=True).indices[:l_rerank]
    dev = keys.device
    top_ids = torch.full((l_rerank,), -1, dtype=torch.int32, device=dev)
    top_d = torch.full((l_rerank,), BIG, dtype=torch.float32, device=dev)
    top_ids[:order.numel()] = ids[order]
    top_d[:order.numel()] = keys[order]
    return top_ids, top_d


def scan_all_gated(codes, codebook, mem: InMemory, qf: QueryFilter, query,
                   l_rerank: int, distance_fn=None):
    """Gated full-corpus ADC scan: the serve tier's last degrade rung.

    Every id is a candidate (no posting scan, no graph traversal — one
    pass of the ``pq_scan`` kernel over the in-memory code tier), ranked
    by ADC distance plus ``INVALID_PENALTY`` where the *approximate*
    membership gate rejects. The gate only over-admits, so no truly-valid
    record is pushed behind an invalid one; exactness comes from the
    caller's fetch + exact verify of the returned top-``l_rerank``.

    ``qf`` is one query's device QueryFilter with a leading batch dim of 1;
    ``query`` (D,). Returns ``(top_ids (l_rerank,), top_keys)``; ids whose
    key carries the penalty are approx-invalid fill (the verifier drops
    them). The penalty is one float32 addition, as in ``repro``: at 1e12
    one float32 ulp is 65,536, so every rejected row gets the same key and
    their ties break by id. A custom ``distance_fn`` (``repro``'s contract,
    ``distance_fn(codes (N, M), table (M, K)) -> (N,)``) scores the codes
    in place of ``ops.pq_scan``.
    """
    table = pq_mod.distance_table(codebook, query)
    if search.default_distance(distance_fn):
        d = ops.pq_scan(codes, table)
    else:
        d = distance_fn(codes, table)
    n = codes.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=codes.device)
    ok = is_member_approx(qf, ids[None, :], mem)[0]
    penalty = torch.where(ok, 0.0, INVALID_PENALTY).to(torch.float32)
    return _stable_topl(ids, d + penalty, l_rerank)


def _verify_core(qf: QueryFilter, query, top_ids, vecs, rl, rv, k: int,
                 pages_std: int):
    """Exact distance + exact verification over already-fetched record
    fields of one query (``qf`` fields carry a leading batch dim of 1)."""
    live = top_ids >= 0
    ex_d = torch.where(live, sq_dist(vecs, query[None, :]), BIG)
    ok = is_member(qf, rl[None], rv[None])[0] & live
    key = torch.where(ok, ex_d, BIG)
    order = torch.sort(key, stable=True).indices[:k]
    ok_o = ok[order]
    ids = torch.where(ok_o, top_ids[order], -1)
    dists = torch.where(ok_o, ex_d[order], float("inf"))
    io = live.sum() * pages_std
    return ids, dists, io, ok.sum()


def _verify_fetched(qf: QueryFilter, query, top_ids, rec: dict,
                    params: PrefilterParams, pages_std: int):
    """Verification over records fetched outside the device tier (the disk
    backend's ``fetch_host``: numpy fields, moved to ``query``'s device)."""
    dev = query.device

    def t(k):
        return torch.from_numpy(rec[k]).to(dev)

    return _verify_core(qf, query, top_ids, t("vectors"), t("rec_labels"),
                        t("rec_values"), params.k, pages_std)


def _rerank_verify(store: RecordStore, qf: QueryFilter, query, top_ids,
                   params: PrefilterParams):
    """Fetch top-(L+δ) records, exact distance + exact verification."""
    safe = torch.where(top_ids >= 0, top_ids, 0).long()
    return _verify_core(qf, query, top_ids, store.vectors[safe],
                        store.rec_labels[safe], store.rec_values[safe],
                        params.k, store.pages_std)


def prefilter_search(store: RecordStore, codes, codebook, selectors, qfilters,
                     queries, params: PrefilterParams,
                     speculative: bool = True,
                     distance_fn=None, host_fetch=None) -> PrefilterResult:
    """Host-driven pre-filtering for a query batch.

    ``speculative=True`` uses Selector.pre_filter_approx (partial scans,
    heavy-branch pruning); ``False`` forces exact full-constraint scans
    (the strict baseline).

    ``host_fetch`` (disk backend: ``DiskRecordStore.fetch_host``) replaces
    the record gather of the re-rank: the top-(L+δ) records are read from
    the slab files through the page cache — same fields, same
    verification, the same output. ``distance_fn`` is :func:`_pq_topl`'s."""
    with trace.span("prefilter.search", rows=len(selectors)):
        dev = codes.device
        B = len(selectors)
        queries = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
        qf_dev = filter_to_device(qfilters, dev)
        out_ids, out_d, ios, nvs = [], [], [], []
        pages = np.zeros(B, np.int64)
        dist_comps = np.zeros(B, np.int64)
        for b in range(B):
            sel: Selector = selectors[b]
            if speculative:
                cand, pg = sel.pre_filter_approx()
            else:
                cand, pg = _strict_scan(sel)
            cand = np.asarray(cand, np.int32)[:params.max_candidates]
            qf = QueryFilter(*(x[b:b + 1] for x in qf_dev))
            top_ids, _ = _pq_topl(codes, codebook, queries[b],
                                  torch.from_numpy(cand).to(dev),
                                  params.l_rerank, distance_fn)
            if host_fetch is None:
                ids, dists, io, nv = _rerank_verify(store, qf, queries[b],
                                                    top_ids, params)
            else:
                tid = trace.to_host(top_ids).numpy()
                ids, dists, io, nv = _verify_fetched(
                    qf, queries[b], top_ids,
                    host_fetch(np.where(tid >= 0, tid, 0)), params,
                    store.pages_std)
            out_ids.append(ids)
            out_d.append(dists)
            ios.append(io)
            nvs.append(nv)
            pages[b] = pg
            dist_comps[b] = cand.size
        io_pages = trace.to_host(torch.stack(ios)) + torch.from_numpy(pages)
        return PrefilterResult(
            ids=torch.stack(out_ids), dists=torch.stack(out_d),
            io_pages=io_pages, dist_comps=torch.from_numpy(dist_comps),
            n_valid=trace.to_host(torch.stack(nvs)))


def _strict_scan(sel: Selector) -> tuple[np.ndarray, int]:
    """Exact pre-filter: evaluate every branch (no pruning/speculation)."""
    from repro_torch.core.selectors import (AndSelector, LabelAndSelector,
                                            LabelOrSelector, OrSelector,
                                            RangeSelector)
    if isinstance(sel, LabelAndSelector):
        merged, pages = sel._fetch_merged(sel.labels, "and")
        return merged.astype(np.int32), pages
    if isinstance(sel, LabelOrSelector):
        merged, pages = sel._fetch_merged(sel.labels, "or")
        return merged.astype(np.int32), pages
    if isinstance(sel, RangeSelector):
        ids, pages = sel._fs.scan(sel.lo, sel.hi)
        return ids.astype(np.int32), pages
    if isinstance(sel, AndSelector):
        # every branch (optional label + all range predicates), intersected
        ids, pages = _strict_scan(sel.children[0])
        for c in sel.children[1:]:
            more, p = _strict_scan(c)
            ids = np.intersect1d(ids, more)
            pages += p
        return ids.astype(np.int32), pages
    if isinstance(sel, OrSelector):
        a, pa = _strict_scan(sel.label_sel)
        b, pb = _strict_scan(sel.range_sel)
        return np.union1d(a, b).astype(np.int32), pa + pb
    return sel.pre_filter_approx()

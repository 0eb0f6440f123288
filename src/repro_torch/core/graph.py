"""Vamana graph construction (paper §5.1) + ACORN-style 2-hop densification
(paper §4.1).

Counterpart of ``repro.core.graph``: its sequential numpy reference build
(:func:`build_vamana`, the correctness oracle, navigating with
:func:`greedy_search`) and its batched builder. An insertion batch of B
nodes is processed by the batched builder as one set of tensor operations:

1. **Navigation** (:func:`greedy_search_beam`): a beam search from the
   medoid for every node of the batch at once, each row stopping on its own
   condition (rows that stopped keep their state).
2. **Vectorized RobustPrune** (:func:`robust_prune_batch`): each node's
   candidate set (search pool ∪ old out-edges, deduped and id-sorted) is
   stable-sorted by distance to the insert point; the domination scan runs
   in the ``prune_scan`` kernel (``kernels.ops.prune_scan``), keeping ≤ R
   survivors where survivor i prunes every j with α²·d(i, j) ≤ d(p, j).
3. **Reverse edges** (:func:`_scatter_pairs`): the batch's (target, source)
   pairs are segment-sorted by target (stable in batch order), ranked within
   each target run, and the first ``free_slots(target)`` ranks are written
   with one scatter. Targets without free slots are re-pruned over
   (old row ∪ pending sources) in capped rounds (:func:`_drain_overflow`).

The host RNG stream (initial graph, pass permutations, 2-hop sample) is the
JAX package's ``np.random.default_rng`` stream, so both builders start from
the same random graph and visit nodes in the same order.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.pq import no_tf32
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sq_dist_fma

_INT_MAX = int(np.iinfo(np.int32).max)
STOP_CHECK = 8        # hops between the navigator's all-rows-stopped checks


# ---------------------------------------------------------------------------
# Batched greedy (beam) search over an adjacency array — build navigator.
# ---------------------------------------------------------------------------

def _sqd(data: torch.Tensor, ids: torch.Tensor, q: torch.Tensor):
    """Squared distances of data[ids] (B, C) to queries q (B, D)."""
    return ((data[ids.long()] - q[:, None, :]) ** 2).sum(-1)


def greedy_search(data, adj, entry: int, queries, ell: int, max_hops: int):
    """Best-first search with a size-``ell`` pool and exact distances, one
    node explored per step: ``repro``'s ``greedy_search`` with the query
    batch as the leading dimension. data (N, D); adj (N', R) int32 (-1 pad;
    extra scratch rows are unreachable); queries (B, D). Returns (pool_ids,
    pool_dists), each (B, ell) ascending.

    As in ``repro``, the explored node's neighbours are deduplicated
    against the pool only (a neighbour listed twice enters twice), a
    duplicate keeps its id with an infinite distance, and the merge is one
    stable sort. Distances are ``kernels.ref.sq_dist_fma``'s chain, which
    is XLA-CPU's sum over rows of up to 32 floats, so at such widths the
    pools equal ``repro``'s; a row whose pool has no finite unexplored
    entry stops (keeps its state) while the others go on."""
    B = queries.shape[0]
    dev = queries.device
    inf = float("inf")
    pool_ids = torch.full((B, ell), -1, dtype=torch.int32, device=dev)
    pool_ids[:, 0] = int(entry)
    pool_d = torch.full((B, ell), inf, device=dev)
    pool_d[:, 0] = sq_dist_fma(data[int(entry)][None, :], queries)
    explored = torch.zeros((B, ell), dtype=torch.bool, device=dev)
    for hop in range(max_hops):
        run = (~explored & torch.isfinite(pool_d)).any(1)      # (B,)
        if hop % STOP_CHECK == 0 and not bool(run.any()):
            break
        masked = torch.where(explored, inf, pool_d)
        i = torch.argmin(masked, dim=1, keepdim=True)          # first min
        exp_new = explored.scatter(1, i, torch.ones_like(i, dtype=torch.bool))
        cur = torch.gather(pool_ids, 1, i)
        nbrs = adj[torch.where(cur >= 0, cur, 0).long()[:, 0]]  # (B, R)
        valid = nbrs >= 0
        nv = torch.where(valid, nbrs, 0).long()
        nd = torch.where(valid, sq_dist_fma(data[nv], queries[:, None, :]),
                         inf)
        dup = (nbrs[:, :, None] == pool_ids[:, None, :]).any(2)
        nd = torch.where(dup, inf, nd)
        srt, order = torch.sort(torch.cat([pool_d, nd], 1), dim=1,
                                stable=True)
        order = order[:, :ell]
        keep = run[:, None]
        pool_ids = torch.where(keep, torch.gather(
            torch.cat([pool_ids, nbrs], 1), 1, order), pool_ids)
        pool_d = torch.where(keep, srt[:, :ell], pool_d)
        explored = torch.where(keep, torch.gather(
            torch.cat([exp_new, torch.zeros_like(valid)], 1), 1, order),
            explored)
    return pool_ids, pool_d


def greedy_search_beam(data, adj, entry: int, queries, ell: int,
                       max_hops: int, width: int = 4):
    """Beam variant: explores the ``width`` best unexplored pool entries per
    step. Returns (pool_ids, pool_dists): (B, ell) ascending."""
    return _beam_pool(adj, entry, queries.shape[0], ell, max_hops, width,
                      lambda ids: _sqd(data, ids, queries))


def _beam_pool(adj, entry, B, ell, max_hops, width, dist_fn):
    """The beam-pool navigation of ``repro``'s ``_beam_pool`` with the
    batch of B queries as the leading dimension and a pluggable distance:
    ``dist_fn(ids (B, C) int32) -> (B, C)`` float32 (ids already clamped
    non-negative; this navigator masks invalid lanes to +inf). Exact
    distances for :func:`greedy_search_beam`, ADC distances for the sharded
    build's PQ navigation (``core/distributed.py``). Each row explores its
    ``width`` best unexplored pool entries per step, dedups their neighbors
    against its pool and across the beams, and merges by one stable sort; a
    row whose pool has no finite unexplored entry stops (keeps its state)
    while the others go on."""
    r = adj.shape[1]
    c = width * r
    dev = adj.device
    pool_ids = torch.full((B, ell), -1, dtype=torch.int32, device=dev)
    pool_ids[:, :1] = int(entry)
    pool_d = torch.full((B, ell), float("inf"), device=dev)
    pool_d[:, :1] = dist_fn(pool_ids[:, :1])
    explored = torch.zeros((B, ell), dtype=torch.bool, device=dev)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), -1)
    inf = float("inf")
    for hop in range(max_hops):
        run = (~explored & torch.isfinite(pool_d)).any(1)      # (B,)
        if hop % STOP_CHECK == 0 and not bool(run.any()):
            break
        masked = torch.where(explored, inf, pool_d)
        sel = torch.sort(masked, dim=1, stable=True).indices[:, :width]
        cur_live = torch.isfinite(torch.gather(masked, 1, sel))
        exp_new = explored.scatter(1, sel, torch.ones_like(cur_live))
        cur = torch.where(cur_live, torch.gather(pool_ids, 1, sel), 0)
        nbrs = adj[cur.long()]                                  # (B, w, r)
        nbrs = torch.where(cur_live[:, :, None], nbrs, -1).reshape(B, c)
        valid = nbrs >= 0
        nd = torch.where(valid, dist_fn(torch.where(valid, nbrs, 0)), inf)
        # dedup against the pool and across the beams' rows
        dup = (nbrs[:, :, None] == pool_ids[:, None, :]).any(2)
        dup |= ((nbrs[:, :, None] == nbrs[:, None, :]) & tri).any(2)
        nd = torch.where(dup, inf, nd)
        all_d = torch.cat([pool_d, nd], 1)
        srt, order = torch.sort(all_d, dim=1, stable=True)
        order = order[:, :ell]
        new_ids = torch.gather(torch.cat([pool_ids, nbrs], 1), 1, order)
        new_exp = torch.gather(
            torch.cat([exp_new, torch.zeros_like(valid)], 1), 1, order)
        keep = run[:, None]
        pool_ids = torch.where(keep, new_ids, pool_ids)
        pool_d = torch.where(keep, srt[:, :ell], pool_d)
        explored = torch.where(keep, new_exp, explored)
    return pool_ids, pool_d


# ---------------------------------------------------------------------------
# The sequential reference builder (numpy RobustPrune, squared distances ->
# alpha^2 domination): ``repro``'s correctness oracle of the batched build
# ---------------------------------------------------------------------------

def robust_prune(p_vec: np.ndarray, cand_ids: np.ndarray,
                 cand_vecs: np.ndarray, r: int, alpha: float) -> np.ndarray:
    """Vamana RobustPrune: keep ≤ r diverse candidates (numpy)."""
    if cand_ids.size == 0:
        return cand_ids
    d_p = np.sum((cand_vecs - p_vec[None, :]) ** 2, axis=1)
    order = np.argsort(d_p, kind="stable")
    a2 = alpha * alpha
    pruned = np.zeros(cand_ids.size, dtype=bool)
    keep: list[int] = []
    for idx in order:
        if pruned[idx]:
            continue
        keep.append(idx)
        if len(keep) >= r:
            break
        d_kc = np.sum((cand_vecs - cand_vecs[idx][None, :]) ** 2, axis=1)
        pruned |= a2 * d_kc <= d_p
        pruned[idx] = True
    return cand_ids[np.array(keep, dtype=np.int64)]


def build_vamana(data: np.ndarray, r: int = 32, ell: int = 64,
                 alpha: float = 1.2, batch: int = 1024, seed: int = 0,
                 device=None) -> tuple[np.ndarray, int]:
    """Sequential reference build. Returns (adjacency (N, r) int32,
    medoid).

    Robust pruning and reverse-edge insertion run in numpy Python loops,
    node by node; each batch of ``batch`` nodes is navigated at once by
    :func:`greedy_search` on ``device`` (the card unless the caller asks
    for the CPU) over the adjacency as it stood at the batch's start. Use
    :func:`build_vamana_batched` for the fast path."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    medoid = int(np.argmin(np.sum((data - data.mean(0, keepdims=True)) ** 2,
                                  1)))

    # random initial graph
    adj = rng.integers(0, n, size=(n, r), dtype=np.int64).astype(np.int32)
    adj[adj == np.arange(n, dtype=np.int32)[:, None]] = medoid

    data_dev = torch.from_numpy(data).to(device)

    for alpha_pass in (1.0, alpha):
        order = rng.permutation(n)
        for start in range(0, n, batch):
            ids = order[start:start + batch]
            adj_dev = torch.from_numpy(adj).to(device)
            pool_ids, _ = greedy_search(
                data_dev, adj_dev, medoid,
                data_dev[torch.from_numpy(ids).to(device)], ell,
                max_hops=ell)
            pool_ids = pool_ids.cpu().numpy()
            for k, p in enumerate(ids):
                cands = np.concatenate([pool_ids[k], adj[p]])
                cands = np.unique(cands[(cands >= 0) & (cands != p)])
                kept = robust_prune(data[p], cands, data[cands], r,
                                    alpha_pass)
                row = np.full(r, -1, np.int32)
                row[:kept.size] = kept
                adj[p] = row
                # reverse edges
                for q in kept:
                    qrow = adj[q]
                    if p in qrow:
                        continue
                    slot = np.where(qrow < 0)[0]
                    if slot.size:
                        adj[q, slot[0]] = p
                    else:
                        rc = np.unique(np.concatenate([qrow, [p]]))
                        rc = rc[(rc >= 0) & (rc != q)]
                        kept_q = robust_prune(data[q], rc, data[rc], r,
                                              alpha_pass)
                        qnew = np.full(r, -1, np.int32)
                        qnew[:kept_q.size] = kept_q
                        adj[q] = qnew
    return adj, medoid


# ---------------------------------------------------------------------------
# Batched RobustPrune + reverse-edge scatter
# ---------------------------------------------------------------------------

def _dedup_ascending(cands: torch.Tensor, self_ids: torch.Tensor):
    """Row-wise unique ascending ids; drops negatives and the row's own id.
    (B, C) int32 -> (B, C) int32 with -1 right-padding."""
    x = torch.where((cands < 0) | (cands == self_ids[:, None]), _INT_MAX,
                    cands)
    x = torch.sort(x, dim=1).values
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[:, 1:] = x[:, 1:] == x[:, :-1]
    x = torch.sort(torch.where(dup, _INT_MAX, x), dim=1).values
    return torch.where(x == _INT_MAX, -1, x)


def robust_prune_batch(data: torch.Tensor, p_ids: torch.Tensor,
                       cand_ids: torch.Tensor, r: int,
                       alpha: float) -> torch.Tensor:
    """Vectorized RobustPrune for a whole insertion batch.

    data (N, D); p_ids (B,) int32 (an id past N — the dump row — prunes an
    empty candidate set); cand_ids (B, C) int32 unique ascending with -1
    right-padding. Returns (B, r) int32 rows, survivors in keep (distance)
    order, -1 pad."""
    no_tf32()
    a2 = float(alpha) * float(alpha)
    b, c = cand_ids.shape
    n = data.shape[0]
    valid = cand_ids >= 0
    cv = data[torch.where(valid, cand_ids, 0).long()]        # (B, C, D)
    pv = data[p_ids.long().clamp(0, n - 1)]                  # (B, D)
    d_p = torch.where(valid, ((cv - pv[:, None, :]) ** 2).sum(-1),
                      float("inf"))
    dp_s, order = torch.sort(d_p, dim=1, stable=True)
    ids_s = torch.gather(cand_ids, 1, order)
    cv_s = torch.gather(cv, 1, order[:, :, None].expand(-1, -1, cv.shape[2]))
    sq = (cv_s * cv_s).sum(-1)                               # (B, C)
    dcc = sq[:, :, None] + sq[:, None, :] \
        - 2.0 * torch.bmm(cv_s, cv_s.transpose(1, 2))
    dcc = dcc.clamp(min=0.0).contiguous()
    keep_s = ops.prune_scan(dp_s.contiguous(), dcc, a2, r)   # (B, C) bool
    rank = torch.cumsum(keep_s.int(), dim=1) - 1
    # column r is a dump column for the dropped lanes
    rows = torch.full((b, r + 1), -1, dtype=torch.int32, device=data.device)
    rows.scatter_(1, torch.where(keep_s, rank, r),
                  torch.where(keep_s, ids_s, -1))
    return rows[:, :r].contiguous()


def _scatter_pairs(adj_ext: torch.Tensor, tgt: torch.Tensor,
                   src: torch.Tensor):
    """Batched reverse-edge insertion: one scatter for all (tgt, src) pairs.

    adj_ext (N+1, R) int32 — row N is an all(-1) dump row for masked writes.
    Pairs are segment-sorted by target (stable in pair order) and ranked;
    rank k lands in the target's k-th free slot. Updates ``adj_ext`` in
    place and returns (adj_ext, sorted_tgt, sorted_src, overflow_mask):
    overflow pairs are valid pairs whose target had no free slot left."""
    n1, r = adj_ext.shape
    dump = n1 - 1
    p = tgt.shape[0]
    dev = adj_ext.device
    valid = (tgt >= 0) & (src >= 0) & (tgt != src)
    safe_t = torch.where(valid, tgt, dump)
    # skip pairs whose edge already exists
    valid &= ~(adj_ext[safe_t.long()] == src[:, None]).any(1)
    pos = torch.arange(p, device=dev)
    order = torch.sort(torch.where(valid, safe_t, dump), stable=True).indices
    st, ss, sv = safe_t[order], src[order], valid[order]
    is_first = torch.ones_like(sv)
    is_first[1:] = st[1:] != st[:-1]
    seg_start = torch.cummax(torch.where(is_first, pos, -1), 0).values
    rank = pos - seg_start
    rowq = adj_ext[st.long()]                                 # (P, R)
    free = rowq < 0
    n_free = free.sum(1)
    colpos = torch.arange(r, device=dev)[None, :].expand(p, r)
    slot_order = torch.sort(torch.where(free, colpos, r + colpos), dim=1,
                            stable=True).indices
    slot = torch.gather(slot_order, 1, rank.clamp(max=r - 1)[:, None])[:, 0]
    do = sv & (rank < n_free)
    adj_ext[torch.where(do, st, dump).long(), torch.where(do, slot, 0)] = \
        torch.where(do, ss, -1)
    overflow = sv & (rank >= n_free)
    return adj_ext, st, ss, overflow


def write_rows(buf: torch.Tensor, rows, start: int) -> torch.Tensor:
    """In-place row write ``buf[start:start+len(rows)] = rows``; returns
    ``buf``. (The JAX package donates the buffer to a jitted update to
    avoid a functional copy; a PyTorch tensor is written in place.)"""
    rows = torch.as_tensor(rows).to(buf.device, buf.dtype)
    buf[start:start + rows.shape[0]] = rows
    return buf


def apply_pruned_rows(adj_ext: torch.Tensor, ids: torch.Tensor,
                      live: torch.Tensor, rows: torch.Tensor):
    """Row set + reverse-edge scatter of pruned rows: the back half of
    :func:`_link_batch` (and of a sharded build's link step). ``adj_ext``
    is updated in place; returns what :func:`_scatter_pairs` returns."""
    dump = adj_ext.shape[0] - 1
    rows = torch.where(live[:, None], rows, -1)
    adj_ext[torch.where(live, ids, dump).long()] = rows
    tgt = rows.reshape(-1)
    src = ids.repeat_interleave(rows.shape[1])
    return _scatter_pairs(adj_ext, tgt, src)


def _link_batch(data, adj_ext, ids, live, pool_ids, r: int, alpha: float):
    """Prune an insertion batch's rows and scatter their reverse edges
    (``adj_ext`` is updated in place)."""
    cand = torch.cat([pool_ids, adj_ext[ids.long()]], dim=1)
    cand = _dedup_ascending(cand, ids)
    rows = robust_prune_batch(data, ids, cand, r=r, alpha=alpha)
    return apply_pruned_rows(adj_ext, ids, live, rows)


def _pow2_pad(m: int, lo: int = 32) -> int:
    return max(lo, 1 << (max(m, 1) - 1).bit_length())


def _pad_batch(ids: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad an insertion-id batch to ``width``, repeating the last id;
    the live mask marks pads dead so their rows go to the dump row."""
    live = np.ones(width, bool)
    if ids.size < width:
        live[ids.size:] = False
        ids = np.concatenate(
            [ids, np.full(width - ids.size, ids[-1], np.int32)])
    return ids.astype(np.int32), live


def _prune_rows(data_dev, adj_ext, targets: np.ndarray, srcs: np.ndarray,
                r: int, alpha: float, chunk: int = 4096):
    """Re-prune overflowing rows over (old row ∪ pending sources)."""
    dump = adj_ext.shape[0] - 1
    dev = adj_ext.device
    for s in range(0, targets.shape[0], chunk):
        t = targets[s:s + chunk]
        sc = srcs[s:s + chunk]
        pad = _pow2_pad(t.shape[0]) - t.shape[0]
        if pad:
            # padded targets resolve to the dump row: an empty candidate set
            # writes an all(-1) row back into it
            t = np.concatenate([t, np.full(pad, dump, t.dtype)])
            sc = np.concatenate(
                [sc, np.full((pad, sc.shape[1]), -1, sc.dtype)])
        t_dev = torch.from_numpy(t).to(dev)
        cand = torch.cat([adj_ext[t_dev.long()],
                          torch.from_numpy(sc).to(dev)], dim=1)
        cand = _dedup_ascending(cand, t_dev)
        rows = robust_prune_batch(data_dev, t_dev, cand, r=r, alpha=alpha)
        adj_ext[t_dev.long()] = rows
    return adj_ext


def _group_overflow(st, ss, overflow, ov_cap: int):
    """Host-side: group overflow pairs by target (already target-sorted).

    Returns (targets (T,), srcs (T, ov_cap) -1-padded, leftover (tgt, src))
    where leftover holds each target's sources beyond ``ov_cap``."""
    ov = overflow.cpu().numpy()
    if not ov.any():
        return None
    t = st.cpu().numpy()[ov]
    s = ss.cpu().numpy()[ov]
    uniq, start, cnt = np.unique(t, return_index=True, return_counts=True)
    gidx = np.repeat(np.arange(uniq.size), cnt)
    posg = np.arange(t.size) - np.repeat(start, cnt)
    take = posg < ov_cap
    srcs = np.full((uniq.size, ov_cap), -1, np.int32)
    srcs[gidx[take], posg[take]] = s[take]
    return uniq.astype(np.int32), srcs, (t[~take], s[~take])


def _drain_overflow(data_dev, adj_ext, st, ss, overflow, n_rows: int,
                    r: int, alpha: float):
    """Drain a batch's pending reverse-edge overflow rounds."""
    # a narrow candidate width r+8 keeps the O(C²·D) prune cheap; rare hot
    # targets take extra rounds, each consuming another 8 sources
    ov_cap = 8
    # every round consumes ≥ ov_cap pending sources per remaining target,
    # so ceil(B/ov_cap) rounds is a hard bound; exceeding it is a bug
    max_rounds = -(-n_rows // ov_cap) + 2
    dev = adj_ext.device
    for _ in range(max_rounds):
        grouped = _group_overflow(st, ss, overflow, ov_cap=ov_cap)
        if grouped is None:
            break
        targets, srcs, (lt, ls) = grouped
        adj_ext = _prune_rows(data_dev, adj_ext, targets, srcs, r, alpha)
        if lt.size == 0:
            break
        pad = _pow2_pad(lt.size) - lt.size
        tgt = np.concatenate([lt, np.full(pad, -1, lt.dtype)]).astype(np.int32)
        src = np.concatenate([ls, np.full(pad, -1, ls.dtype)]).astype(np.int32)
        adj_ext, st, ss, overflow = _scatter_pairs(
            adj_ext, torch.from_numpy(tgt).to(dev),
            torch.from_numpy(src).to(dev))
    else:
        raise RuntimeError(
            "reverse-edge overflow failed to drain within the round bound; "
            "this indicates a bug in the scatter/overflow bookkeeping")
    return adj_ext


def _apply_batch(data_dev, adj_ext, ids: np.ndarray, live: np.ndarray,
                 pool_ids, r: int, alpha: float):
    """One insertion batch: prune + row set + reverse scatter + overflow."""
    dev = adj_ext.device
    adj_ext, st, ss, overflow = _link_batch(
        data_dev, adj_ext, torch.from_numpy(ids).to(dev),
        torch.from_numpy(live).to(dev), pool_ids, r=r, alpha=alpha)
    return _drain_overflow(data_dev, adj_ext, st, ss, overflow,
                           ids.shape[0], r, alpha)


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU), before reading a clock."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def build_vamana_batched(data: np.ndarray, r: int = 32, ell: int = 64,
                         alpha: float = 1.2, batch: int = 1024,
                         seed: int = 0, device=None,
                         timings: dict | None = None
                         ) -> tuple[np.ndarray, int]:
    """Batched Vamana build on ``device`` (the card unless the caller asks
    for the CPU; same RNG stream as the JAX package's). Returns (adjacency
    (N, r) int32 padded -1, medoid). ``timings``, when given, receives the
    seconds of each pass."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    medoid = int(np.argmin(np.sum((data - data.mean(0, keepdims=True)) ** 2,
                                  1)))

    adj0 = rng.integers(0, n, size=(n, r), dtype=np.int64).astype(np.int32)
    adj0[adj0 == np.arange(n, dtype=np.int32)[:, None]] = medoid

    data_dev = torch.from_numpy(data).to(device)
    adj_ext = torch.cat([torch.from_numpy(adj0),
                         torch.full((1, r), -1, dtype=torch.int32)]).to(device)
    batch = min(batch, _pow2_pad(n))

    for pass_i, alpha_pass in enumerate((1.0, alpha)):
        t0 = time.perf_counter()
        # the α=1 bootstrap pass only seeds the final α-pass with a usable
        # graph; a ⅔-width pool there cuts navigation time
        pell = ell if pass_i else max(16, (2 * ell) // 3)
        order = rng.permutation(n)
        for start in range(0, n, batch):
            ids, live = _pad_batch(order[start:start + batch].astype(
                np.int32), batch)
            ids_dev = torch.from_numpy(ids).to(device)
            pool_ids, _ = greedy_search_beam(data_dev, adj_ext, medoid,
                                             data_dev[ids_dev.long()],
                                             pell, max_hops=pell)
            adj_ext = _apply_batch(data_dev, adj_ext, ids, live, pool_ids,
                                   r=r, alpha=float(alpha_pass))
        if timings is not None:
            sync(device)
            timings[f"pass{pass_i + 1}_s"] = time.perf_counter() - t0
    return adj_ext[:-1].cpu().numpy(), medoid


class IncrementalBuilder:
    """Appends batches of new nodes to a live Vamana graph on ``device``.

    Counterpart of ``repro.core.graph.IncrementalBuilder``. Wraps (data,
    adjacency, medoid) with geometric capacity growth, so the engine's
    capacity-padded stores keep their shape across most inserts.
    :meth:`add_batch` links each new node with a single final-α pass
    (greedy search from the medoid → batched RobustPrune on the
    ``prune_scan`` kernel → batched reverse-edge scatter). Unreached
    capacity rows hold zero vectors and empty (-1) adjacency: no stored
    edge points at them, so searches cannot reach them. The adjacency's
    extra last row is the dump row of masked writes.
    """

    def __init__(self, data, adj, medoid: int, ell: int = 64,
                 alpha: float = 1.2, batch: int = 1024, device=None):
        """``data`` (N, D) and ``adj`` (N, R): numpy arrays or tensors,
        copied onto ``device`` (the builder owns its state)."""
        self.device = resolve_device(device)
        data = torch.as_tensor(data, dtype=torch.float32).to(
            self.device).clone()
        adj = torch.as_tensor(adj, dtype=torch.int32).to(self.device)
        assert data.shape[0] == adj.shape[0]
        self.n = data.shape[0]
        self.r = adj.shape[1]
        self.ell = ell
        self.alpha = float(alpha)
        self.batch = batch
        self.medoid = int(medoid)
        self._cap = self.n
        self._data_dev = data
        self._adj_ext = torch.cat(
            [adj, torch.full((1, self.r), -1, dtype=torch.int32,
                             device=self.device)])

    @classmethod
    def build(cls, data: np.ndarray, r: int = 32, ell: int = 64,
              alpha: float = 1.2, batch: int = 1024, seed: int = 0,
              device=None) -> "IncrementalBuilder":
        """A builder over the batched build of ``data`` on ``device``."""
        adj, medoid = build_vamana_batched(data, r, ell, alpha, batch, seed,
                                           device=device)
        return cls(data, adj, medoid, ell=ell, alpha=alpha, batch=batch,
                   device=device)

    # -- state ----------------------------------------------------------
    @property
    def adjacency(self) -> np.ndarray:
        """(n, R) int32 adjacency of the live nodes, on the host."""
        return self._adj_ext[:self.n].cpu().numpy()

    @property
    def data(self) -> np.ndarray:
        """(n, D) float32 vectors of the live nodes, on the host."""
        return self._data_dev[:self.n].cpu().numpy()

    @property
    def capacity(self) -> int:
        """Allocated rows; grows geometrically, ≥ n."""
        return self._cap

    @property
    def data_device(self) -> torch.Tensor:
        """(capacity, D) vectors — rows ≥ n are zero pads. Shared with the
        engine's record store and written in place by later inserts."""
        return self._data_dev

    @property
    def adjacency_device(self) -> torch.Tensor:
        """(capacity, R) adjacency — rows ≥ n are -1 pads; a view shared
        with the engine's record store, written in place by later
        inserts."""
        return self._adj_ext[:self._cap]

    def _grow(self, need: int):
        cap = self._cap
        while cap < need:
            cap = max(cap + self.batch, int(cap * 1.5))
        if cap == self._cap:
            return
        data = torch.zeros((cap, self._data_dev.shape[1]),
                           dtype=torch.float32, device=self.device)
        data[:self.n] = self._data_dev[:self.n]
        self._data_dev = data
        adj = torch.full((cap + 1, self.r), -1, dtype=torch.int32,
                         device=self.device)
        adj[:self.n] = self._adj_ext[:self.n]
        self._adj_ext = adj
        self._cap = cap

    # -- streaming insert ----------------------------------------------
    def add_batch(self, vectors: np.ndarray) -> np.ndarray:
        """Insert new vectors; returns their assigned ids (contiguous)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._data_dev.shape[1]:
            raise ValueError(
                f"expected (M, {self._data_dev.shape[1]}) vectors, got "
                f"{vectors.shape}")
        m = vectors.shape[0]
        if m == 0:
            return np.zeros(0, np.int64)
        self._grow(self.n + m)
        new_ids = np.arange(self.n, self.n + m, dtype=np.int64)
        write_rows(self._data_dev, torch.from_numpy(vectors), self.n)
        for s in range(0, m, self.batch):
            ids = new_ids[s:s + self.batch].astype(np.int32)
            ids, live = _pad_batch(
                ids, min(_pow2_pad(ids.size, lo=8), self.batch))
            ids_dev = torch.from_numpy(ids).to(self.device)
            pool_ids, _ = greedy_search_beam(
                self._data_dev, self._adj_ext, self.medoid,
                self._data_dev[ids_dev.long()], self.ell, max_hops=self.ell)
            self._adj_ext = _apply_batch(
                self._data_dev, self._adj_ext, ids, live, pool_ids,
                r=self.r, alpha=self.alpha)
        self.n += m
        return new_ids


# ---------------------------------------------------------------------------
# 2-hop densification + stats
# ---------------------------------------------------------------------------

def densify_2hop(adj: np.ndarray, r_dense: int, seed: int = 0) -> np.ndarray:
    """Random 2-hop sample per node (paper §4.1: ~10–20× direct degree), in
    numpy with the JAX package's RNG stream: random (first-hop, second-hop)
    slot pairs; duplicates and self-references become -1 or are tolerated
    (search dedups)."""
    rng = np.random.default_rng(seed)
    n, r = adj.shape
    i1 = rng.integers(0, r, size=(n, r_dense))
    i2 = rng.integers(0, r, size=(n, r_dense))
    hop1 = np.take_along_axis(adj, i1, axis=1)               # (N, R_d)
    hop1_safe = np.where(hop1 >= 0, hop1, 0)
    hop2 = adj[hop1_safe, i2]                                # (N, R_d)
    hop2 = np.where(hop1 >= 0, hop2, -1)
    hop2 = np.where(hop2 == np.arange(n)[:, None], -1, hop2)
    return hop2.astype(np.int32)


def graph_stats(adj: np.ndarray) -> dict:
    valid = adj >= 0
    deg = valid.sum(1)
    return {"avg_degree": float(deg.mean()), "min_degree": int(deg.min()),
            "max_degree": int(deg.max())}


def reachable_fraction(adj: np.ndarray, start: int) -> float:
    """Share of the graph's nodes reachable from ``start`` (host BFS)."""
    seen = np.zeros(adj.shape[0], bool)
    seen[start] = True
    frontier = np.array([start])
    while frontier.size:
        nb = adj[frontier].reshape(-1)
        nb = np.unique(nb[nb >= 0])
        frontier = nb[~seen[nb]]
        seen[frontier] = True
    return float(seen.mean())


def greedy_recall_at_k(data: np.ndarray, adj: np.ndarray, medoid: int,
                       queries: np.ndarray, ell: int = 64, k: int = 10,
                       max_hops: int = 200, device=None) -> float:
    """Unfiltered recall@k of greedy search over a graph vs exact top-k, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    data_t = torch.as_tensor(np.asarray(data, np.float32)).to(device)
    q_t = torch.as_tensor(np.asarray(queries, np.float32)).to(device)
    ids, _ = greedy_search(data_t, torch.as_tensor(np.asarray(adj, np.int32))
                           .to(device), medoid, q_t, ell=ell,
                           max_hops=max_hops)
    ids = ids.cpu().numpy()
    recalls = []
    for i in range(q_t.shape[0]):
        exact = torch.topk(((data_t - q_t[i]) ** 2).sum(1), k,
                           largest=False).indices.cpu().numpy()
        got = set(ids[i, :k].tolist())
        recalls.append(len(got & set(exact.tolist())) / k)
    return float(np.mean(recalls))

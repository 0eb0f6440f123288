"""Sharded filtered search and Vamana build over a plan of devices.

Counterpart of ``repro.core.distributed``. The record store ("SSD":
vectors, adjacency, 2-hop lists, attributes and the ``cand_first`` dedup
bits) is split by vector-id range into S shards; the in-memory tier (PQ
codes, Bloom words, bucket codes, the per-query visited and rare-list
bitmaps) is replicated. A record fetch gathers each id from the shard
that owns it.

``repro`` runs one program per device under ``shard_map`` over a JAX mesh.
The port is single-controller instead: a :class:`ShardPlan` is an explicit
tuple of S ``torch.device``s and one host process drives every shard, so
the collectives are written out:

* **all-gather (tiled)** is a ``torch.cat`` of the shards' id blocks in
  shard order;
* **psum over owners** is an owner-select: each shard gathers the ids it
  owns from its rows, the result moves to the consumer's device (``.to``,
  a no-op on one card) and each id takes its owner's row. ``repro`` sums
  masked pulls (shifting id-valued fields by one so the -1 pads survive,
  counting ``cand_first`` in int32); exactly one shard owns each id, so
  the select gives the same bits.

:func:`local_plan` repeats one device S times, which is how the engine
shards on one card (and how the tests shard on the CPU): every shard's
records are then ``narrow`` views of the one store, so sharding copies
nothing. A plan over distinct devices runs the same code.

Two query layouts share that store layout, as in ``repro``:

* :class:`ShardedSearchRunner` — queries row-sharded: each shard runs the
  hop step for its B/S contiguous rows, and each hop issues one fetch of
  the all-gathered frontier. It plugs into
  ``search.filtered_search_pipelined(runner=)``.
* :func:`distributed_filtered_search` — queries replicated: the minimal
  sharded entry and the runner's oracle.

:func:`build_vamana_sharded` splits each insertion batch's rows over the
shards: navigation (optionally on PQ-approximate ADC distances) and the
exact RobustPrune (the ``prune_scan`` kernel) run per shard, the pruned
rows are concatenated, and the reverse-edge scatter and overflow rounds
run once (``graph.apply_pruned_rows`` / ``graph._drain_overflow``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import graph as graph_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core.records import RecordStore
from repro_torch.core.selectors import InMemory, QueryFilter
from repro_torch.device import resolve_device

_RECORD_FIELDS = ("vectors", "neighbors", "dense_neighbors", "rec_labels",
                  "rec_values")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """S shards, shard s on ``devices[s]``; the record store's rows split
    into S contiguous blocks in that order."""
    devices: tuple

    @property
    def n_shards(self) -> int:
        return len(self.devices)


def local_plan(shards: int, device=None) -> ShardPlan:
    """``shards`` shards on one device (``None``: the card)."""
    return ShardPlan(devices=(resolve_device(device),) * int(shards))


def pad_store(store: RecordStore, n_shards: int) -> RecordStore:
    """Pad N to a shard multiple (pad records are never reachable): vectors
    and values 0, ids and labels -1, ``cand_first`` False."""
    n = store.n
    extra = -(-n // n_shards) * n_shards - n
    if extra == 0:
        return store

    def pad(t, fill):
        return torch.cat([t, torch.full((extra,) + tuple(t.shape[1:]), fill,
                                        dtype=t.dtype, device=t.device)])

    return RecordStore(
        vectors=pad(store.vectors, 0.0), neighbors=pad(store.neighbors, -1),
        dense_neighbors=pad(store.dense_neighbors, -1),
        rec_labels=pad(store.rec_labels, -1),
        rec_values=pad(store.rec_values, 0.0),
        pages_std=store.pages_std, pages_dense=store.pages_dense,
        cand_first=(None if store.cand_first is None
                    else pad(store.cand_first, False)))


def store_shardings(plan: ShardPlan, store: RecordStore) -> list:
    """The S per-shard stores of a store whose N divides by S: shard s
    holds rows [s·N/S, (s+1)·N/S) on ``plan.devices[s]`` — ``narrow`` views
    where that is the store's device."""
    s_n = plan.n_shards
    assert store.n % s_n == 0, (
        f"store of {store.n} rows does not split over {s_n} shards "
        "(pad_store first)")
    size = store.n // s_n

    def part(t, s):
        return None if t is None else t.narrow(0, s * size, size).to(
            plan.devices[s])

    return [RecordStore(*(part(getattr(store, f), s)
                          for f in _RECORD_FIELDS),
                        store.pages_std, store.pages_dense,
                        cand_first=part(store.cand_first, s))
            for s in range(s_n)]


def _owner_pulls(shards: Sequence[RecordStore], ids: torch.Tensor) -> dict:
    """Records of the global ``ids`` (any shape) on the ids' device: each
    shard gathers the ids it owns from its rows (the others its row 0), and
    each id takes its owner's row (the owner-select form of ``repro``'s
    masked gather + psum; see the module docstring)."""
    dev = ids.device
    size = shards[0].n
    flat = ids.reshape(-1).long()
    owner = flat // size
    rec: dict = {}
    for s, sh in enumerate(shards):
        sdev = sh.vectors.device
        mine = owner == s
        got = search_mod.local_fetch(
            sh, torch.where(mine, flat - s * size, 0).to(sdev))
        for k, v in got.items():
            v = v.to(dev)
            rec[k] = v if s == 0 else torch.where(
                mine.reshape((-1,) + (1,) * (v.ndim - 1)), v, rec[k])
    return {k: v.reshape(ids.shape + v.shape[1:]) for k, v in rec.items()}


def make_sharded_fetch(plan: ShardPlan, shards: Sequence[RecordStore]
                       ) -> Callable:
    """The replicated-ids fetch over ``shards`` (``plan``'s per-shard
    stores), with ``search.local_fetch``'s contract: ``fetch(store, ids)``
    with ids of any shape returns ``ids.shape + record dims`` per field,
    ``cand_first`` included when the store carries it. Every shard answers
    for the ids it owns, whatever shard's ``store`` is passed."""
    assert len(shards) == plan.n_shards

    def fetch(store: RecordStore, ids: torch.Tensor) -> dict:
        return _owner_pulls(shards, ids)

    return fetch


def make_batch_sharded_fetch(plan: ShardPlan, shards: Sequence[RecordStore]
                             ) -> Callable:
    """The row-sharded-queries flavour of :func:`make_sharded_fetch`.
    ``fetch(store, ids)`` takes the S shards' own id blocks (a sequence in
    shard order, block s of any shape), all-gathers them into the global
    frontier (one tiled ``torch.cat`` on the first shard's device), pulls
    the records from their owners once, and hands block s its records on
    ``plan.devices[s]``: a list of S dicts, each as ``local_fetch`` returns
    for its block. One fetch per hop covers every query row of the batch."""
    assert len(shards) == plan.n_shards
    dev0 = plan.devices[0]

    def fetch(store: RecordStore, ids: Sequence[torch.Tensor]) -> list:
        sizes = [b.numel() for b in ids]
        rec = _owner_pulls(shards, torch.cat(
            [b.reshape(-1).to(dev0) for b in ids]))
        parts = {k: v.split(sizes) for k, v in rec.items()}
        return [{k: p[s].to(plan.devices[s]).reshape(
                     ids[s].shape + p[s].shape[1:])
                 for k, p in parts.items()}
                for s in range(plan.n_shards)]

    return fetch


def _rows(tup, lo: int, n: int, dev):
    """Rows [lo, lo + n) of every tensor of a QueryCtx/HopState on ``dev``
    (``narrow`` views on the same device)."""
    def part(t):
        return t.narrow(0, lo, n).to(dev)
    if isinstance(tup, search_mod.QueryCtx):
        return search_mod.QueryCtx(part(tup.queries), part(tup.tables),
                                   QueryFilter(*(part(x) for x in tup.qf)),
                                   part(tup.merged_tbl))
    return type(tup)(*(part(t) for t in tup))


class ShardedSearchRunner:
    """The sharded hop engine behind ``filtered_search_pipelined(runner=)``.

    Holds the record store padded to a shard multiple and split over
    ``plan`` (:func:`store_shardings`: views on one device), and a replica
    of the PQ codes and the in-memory tier per shard device.

    ``run(ctx, st, n_hops, params, distance_fn)`` mirrors
    ``search.run_hops``: it consumes ``st`` and returns ``(state, active
    mask)``. It splits ``ctx`` and ``st`` into S contiguous row blocks and
    steps every shard's ``search._hop_step`` in lockstep on the host; after
    each hop ONE fetch of the all-gathered frontier
    (:func:`make_batch_sharded_fetch`) brings every shard its rows' records
    for the next hop. The strict_in neighbour reads inside a shard's hop go
    through :func:`make_sharded_fetch`. Every shard takes exactly
    ``n_hops`` steps, so no global "any row active" flag is needed (``repro``
    psums one to end its ``while_loop``): settled rows are exact fixed
    points of the hop step, so extra steps change nothing and results stay
    bit-identical to the single-device driver. The driver's compaction
    keeps bucket widths divisible by S: both are powers of two and
    ``min_bucket`` is raised to ``n_shards``.

    ``repro``'s ``cache_size()`` counts its compiled shard_map kernels; the
    port compiles nothing per call, so it has no such method.
    """

    def __init__(self, plan: ShardPlan, store: RecordStore, codes,
                 codebook, mem: InMemory):
        n_shards = plan.n_shards
        if n_shards & (n_shards - 1):
            raise ValueError(
                f"shard count must be a power of two (got {n_shards}): the "
                "driver's bucket widths must divide evenly over the mesh")
        self.plan = plan
        self.n_shards = n_shards
        self.shards = store_shardings(plan, pad_store(store, n_shards))
        self.codebook = codebook
        self._codes = [codes.to(d) for d in plan.devices]
        self._mem = [InMemory(*(t.to(d) for t in mem)) for d in plan.devices]
        self._fetch = make_batch_sharded_fetch(plan, self.shards)
        self._row_fetch = make_sharded_fetch(plan, self.shards)

    def run(self, ctx: search_mod.QueryCtx, st: search_mod.HopState,
            n_hops: int, params: search_mod.SearchParams, distance_fn=None):
        """``run_hops`` over the shards: (ctx, st, n_hops) -> (st', mask)."""
        S = self.n_shards
        b = st.active.shape[0]
        assert b % S == 0, f"batch of {b} rows does not split over {S} shards"
        nl = b // S
        devs = self.plan.devices
        ctxs = [_rows(ctx, s * nl, nl, devs[s]) for s in range(S)]
        sts = [_rows(st, s * nl, nl, devs[s]) for s in range(S)]
        mcs = [search_mod._mc(self._mem[s], ctxs[s], params, distance_fn)
               for s in range(S)]

        def issue():
            return self._fetch(None, [torch.where(t.cur_live, t.cur_ids, 0)
                                      .reshape(-1) for t in sts])

        recs = issue()
        for _ in range(n_hops):
            sts = [search_mod._hop_step(
                self.shards[s], self._codes[s], self._mem[s], params,
                ctxs[s], mcs[s], sts[s], recs[s], self._row_fetch,
                distance_fn) for s in range(S)]
            recs = issue()
        dev = st.active.device
        out = search_mod.HopState(*(torch.cat([t[i].to(dev) for t in sts])
                                    for i in range(len(st))))
        return out, out.active


def distributed_filtered_search(plan: ShardPlan, store: RecordStore,
                                codes, codebook, mem: InMemory,
                                qfilters: QueryFilter, queries, entry: int,
                                params: search_mod.SearchParams):
    """Single-shot search over the sharded store with the queries
    replicated: the records come through :func:`make_sharded_fetch`, the
    rest is ``search.filtered_search``. In ``repro`` every shard runs the
    whole batch's control flow and ends with the same result; a single
    controller runs that computation once, on the codes' device. The
    store is padded to a shard multiple first. The runner's oracle."""
    shards = store_shardings(plan, pad_store(store, plan.n_shards))
    return search_mod.filtered_search(
        store, codes, codebook, mem, qfilters, queries, entry, params,
        fetch_fn=make_sharded_fetch(plan, shards))


# ---------------------------------------------------------------------------
# Sharded Vamana build
# ---------------------------------------------------------------------------

def _nav_prune(plan: ShardPlan, data, adj_ext, codes, codebook, ids,
               medoid: int, pell: int, r: int, alpha: float,
               width: int = 4) -> torch.Tensor:
    """Navigate and RobustPrune one insertion batch's rows, B/S a shard.

    ``data``, ``adj_ext`` and (with PQ navigation) ``codes``/``codebook``
    are replicated; ``ids`` (B,) splits into S contiguous blocks. With
    ``codes`` the beam pools are steered by ADC distances; the prune
    re-ranks with exact distances either way. Returns the (B, R) pruned
    rows, concatenated in shard order on the first shard's device."""
    dev0 = plan.devices[0]
    bl = ids.shape[0] // plan.n_shards
    rows = []
    for s, dev in enumerate(plan.devices):
        data_s, adj_s = data.to(dev), adj_ext.to(dev)
        ids_s = ids[s * bl:(s + 1) * bl].to(dev)
        q = data_s[ids_s.long()]                          # (B/S, D)
        if codes is not None:
            codes_s = codes.to(dev)
            tables = pq_mod.distance_table(
                pq_mod.PQCodebook(codebook.centroids.to(dev),
                                  codebook.dim), q)       # (B/S, M, K)

            def dist(sids):
                return pq_mod.adc_lookup(codes_s[sids.long()], tables)
        else:
            def dist(sids):
                return graph_mod._sqd(data_s, sids, q)
        pool_ids, _ = graph_mod._beam_pool(adj_s, medoid, bl, pell, pell,
                                           width, dist)
        cand = graph_mod._dedup_ascending(
            torch.cat([pool_ids, adj_s[ids_s.long()]], dim=1), ids_s)
        rows.append(graph_mod.robust_prune_batch(
            data_s, ids_s, cand, r=r, alpha=alpha).to(dev0))
    return torch.cat(rows)


def build_vamana_sharded(data: np.ndarray, plan: ShardPlan, r: int = 32,
                         ell: int = 64, alpha: float = 1.2,
                         batch: int = 1024, seed: int = 0,
                         codes=None, codebook=None,
                         stage_times: dict | None = None
                         ) -> tuple[np.ndarray, int]:
    """Sharded batched Vamana build (the RNG stream and batch schedule of
    ``graph.build_vamana_batched``). Returns (adjacency (N, r) int32, -1
    padded, medoid).

    Each insertion batch's rows split over the plan's shards: navigation and
    RobustPrune run per shard (:func:`_nav_prune`), and the reverse-edge
    scatter and overflow rounds run once on the first shard's device over
    the concatenated rows. Without ``codes`` the result equals
    ``build_vamana_batched``'s; with ``codes``/``codebook`` (a PQ
    codebook and the corpus' codes) the pools are steered by ADC distances,
    the one semantic deviation, held to the batched build's recall ±1%.

    ``stage_times`` (optional dict) accumulates seconds into
    ``nav_prune_s`` (the sharded stage) and ``scatter_s`` (the replicated
    one), each behind a device synchronisation."""
    dev0 = plan.devices[0]
    rng = np.random.default_rng(seed)
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    medoid = int(np.argmin(np.sum((data - data.mean(0, keepdims=True)) ** 2,
                                  1)))

    adj0 = rng.integers(0, n, size=(n, r), dtype=np.int64).astype(np.int32)
    adj0[adj0 == np.arange(n, dtype=np.int32)[:, None]] = medoid

    data_dev = torch.from_numpy(data).to(dev0)
    adj_ext = torch.cat([torch.from_numpy(adj0),
                         torch.full((1, r), -1, dtype=torch.int32)]).to(dev0)
    batch = min(batch, graph_mod._pow2_pad(n))
    assert batch % plan.n_shards == 0, (
        f"batch={batch} must divide over {plan.n_shards} shards")
    if codes is not None:
        assert codebook is not None
        codes = torch.as_tensor(codes).to(dev0)

    for pass_i, alpha_pass in enumerate((1.0, alpha)):
        pell = ell if pass_i else max(16, (2 * ell) // 3)
        order = rng.permutation(n)
        for start in range(0, n, batch):
            ids, live = graph_mod._pad_batch(
                order[start:start + batch].astype(np.int32), batch)
            ids_dev = torch.from_numpy(ids).to(dev0)
            t0 = time.perf_counter()
            rows = _nav_prune(plan, data_dev, adj_ext, codes, codebook,
                              ids_dev, medoid, pell, r, float(alpha_pass))
            if stage_times is not None:
                graph_mod.sync(dev0)
                t1 = time.perf_counter()
                stage_times["nav_prune_s"] = (
                    stage_times.get("nav_prune_s", 0.0) + (t1 - t0))
            adj_ext, st, ss, overflow = graph_mod.apply_pruned_rows(
                adj_ext, ids_dev, torch.from_numpy(live).to(dev0), rows)
            adj_ext = graph_mod._drain_overflow(
                data_dev, adj_ext, st, ss, overflow, ids.shape[0], r,
                float(alpha_pass))
            if stage_times is not None:
                graph_mod.sync(dev0)
                stage_times["scatter_s"] = (
                    stage_times.get("scatter_s", 0.0)
                    + (time.perf_counter() - t1))
    return adj_ext[:-1].cpu().numpy(), medoid

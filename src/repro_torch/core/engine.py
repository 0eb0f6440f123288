"""FilteredANNEngine — the end-to-end system (paper §4 Fig. 4), on PyTorch.

Counterpart of ``repro.core.engine``. Query processing: per-query cost
estimation routes to speculative pre-filtering, speculative in-filtering, or
post-filtering; queries are grouped by (mechanism, pool-size bucket) and
executed as batches; exact verification piggybacks on re-ranking everywhere.

Baseline policies (paper §5.1 compared systems) are selectable:
  * ``speculative`` — the paper's system (cost-model routing).
  * ``basefilter``  — strict pre-filtering when selectivity < 1%, otherwise
                      post-filtering.
  * ``strict_in``   — Filtered-DiskANN-like strict in-filtering.
  * ``strict_pre``  — Milvus-like always-pre-filtering.
  * ``post``        — always post-filtering.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises where there is none.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, distributed, graph, io_sim, \
    pq as pq_mod, prefilter, search
from repro_torch.core.faults import FaultPlan
from repro_torch.core.labels import (LabelStore, build_label_store,
                                     extend_label_store, padded_rows_from_csr,
                                     padded_vec_labels)
from repro_torch.core.ranges import MultiRangeStore, build_multi_range_store
from repro_torch.core.records import (HopGraphs, RecordStore,
                                      candidate_first_mask, make_record_store)
from repro_torch.core.selectors import (InMemory, QueryFilter, Selector,
                                        filter_to_device, is_member,
                                        stack_filters)
from repro_torch.device import resolve_device
from repro_torch.storage import DiskRecordStore, StorageConfig
from repro_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    r: int = 32               # Vamana out-degree
    r_dense: int = 480        # 2-hop sample size (10-20x R, paper §4.1)
    l_build: int = 64
    alpha: float = 1.2
    pq_m: int = 16            # PQ subquantizers
    pq_iters: int = 8
    max_labels: int = 16      # per-record label slots (exact verification)
    ql: int = 8               # max labels per query
    qr: int = 4               # range-predicate slots per query (NR)
    cap: int = 2048           # merged rare-list capacity
    seed: int = 0
    builder: str = "batched"  # 'batched' (the device pipeline) |
                              # 'reference' (graph.build_vamana, the
                              # sequential numpy oracle)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    k: int = 10
    l: int = 32               # base pool length L (recall knob)
    beam_width: int = 1
    max_hops: int = 512
    alpha: float = 10.0       # cost-model IO weight
    beta: float = 1.0
    max_pool: int = 1024      # effective-L cap
    l_rerank_delta: int = 16  # δ extra re-ranked vectors for pre-filtering
    policy: str = "speculative"
    hop_chunk: int = 32       # hops between straggler-compaction checks
                              # (0 = single-shot search)
    prefetch_depth: int = 2   # record slabs in flight per query (feeds the
                              # modeled SSD latency; results are invariant)
    fault_plan: FaultPlan | None = None
                              # seeded fault injection on the record-read
                              # path (core/faults.py) — None serves the
                              # clean hot path


def apply_rung(scfg: SearchConfig,
               rung: "cost_model.DegradeRung") -> SearchConfig:
    """SearchConfig for one degrade-ladder rung (cost_model.DEGRADE_LADDER)."""
    kw = dict(l=max(scfg.k, int(round(scfg.l * rung.l_scale))),
              max_hops=max(8, int(round(scfg.max_hops
                                        * rung.max_hops_scale))))
    if rung.hop_chunk is not None:
        kw["hop_chunk"] = rung.hop_chunk
    if rung.prefetch_depth is not None:
        kw["prefetch_depth"] = rung.prefetch_depth
    return dataclasses.replace(scfg, **kw)


def scan_rerank(scfg: SearchConfig,
                rung: "cost_model.DegradeRung | None" = None) -> int:
    """Re-rank budget of the gated full-scan path for a base config,
    optionally as scaled by ``rung``."""
    l = scfg.l if rung is None else max(scfg.k,
                                        int(round(scfg.l * rung.l_scale)))
    return int(min(scfg.max_pool, max(l + scfg.l_rerank_delta,
                                      2 * scfg.k)))


@dataclasses.dataclass
class QueryStats:
    mechanism: list
    io_pages: np.ndarray
    est_io_pages: np.ndarray
    dist_comps: np.ndarray
    est_compute: np.ndarray
    hops: np.ndarray
    fp_explored: np.ndarray
    explored: np.ndarray
    n_valid: np.ndarray
    selectivity: np.ndarray
    precision_in: np.ndarray
    faults: np.ndarray        # injected fault events (0 without a plan)
    retries: np.ndarray
    degraded: np.ndarray
    disk: dict | None = None  # disk-tier counter delta for this batch
                              # (cache hits/misses/hit_rate, pages_read,
                              # readahead, gated_skips, the host µs of
                              # fetch and of pread); None on the device
                              # backend
    trace: dict | None = None  # the batch's tally (utils/trace.py): groups,
                               # hop steps, live and dispatched row-hops,
                               # explored and falsely admitted records,
                               # graphed hop steps, graph captures, host
                               # seconds by span, device waits

    @classmethod
    def empty(cls) -> "QueryStats":
        z = np.zeros(0, np.int64)
        return cls(mechanism=[], io_pages=z, est_io_pages=np.zeros(0),
                   dist_comps=z, est_compute=np.zeros(0), hops=z,
                   fp_explored=z, explored=z, n_valid=z,
                   selectivity=np.zeros(0), precision_in=np.zeros(0),
                   faults=z, retries=z, degraded=z,
                   trace=trace.new_tally())


class FilteredANNEngine:
    def __init__(self, store: RecordStore, codes, codebook, mem: InMemory,
                 label_store: LabelStore, range_store: MultiRangeStore,
                 medoid: int, config: IndexConfig):
        self.store = store
        self.codes = codes
        self.codebook = codebook
        self.mem = mem
        self.label_store = label_store
        self.range_store = range_store
        self.medoid = medoid
        self.config = config
        self.device = codes.device
        self.n = label_store.n_vectors  # valid records (stores may hold pads)
        self._builder = None      # lazy IncrementalBuilder (insert path)
        self.calibration: cost_model.Calibration | None = None
        self.build_times: dict = {}
        self.disk_store = None    # storage.DiskRecordStore on the disk backend
        self.io_model: io_sim.IOModel | None = None
                                  # fitted from measured reads (calibrate_io)
        self._runner = None       # ShardedSearchRunner when shard()ed

    def calibrate(self, source="BENCH_search.json") -> bool:
        """Swap the router's per-hop compute constants for measured ones
        (a BENCH_search.json payload, a path, or a Calibration). Returns
        True when calibration data was found; ``calibrate(None)`` reverts."""
        if source is None or isinstance(source, cost_model.Calibration):
            self.calibration = source
        elif isinstance(source, dict):
            try:
                self.calibration = cost_model.Calibration.from_bench(source)
            except (KeyError, TypeError, ValueError):
                self.calibration = None
        else:
            self.calibration = cost_model.load_calibration(source)
        return self.calibration is not None

    @property
    def n_fields(self) -> int:
        return self.range_store.n_fields

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, vectors: np.ndarray, label_offsets: np.ndarray,
              label_flat: np.ndarray, n_labels: int, values: np.ndarray,
              config: IndexConfig = IndexConfig(), shards: int = 0,
              device=None) -> "FilteredANNEngine":
        """Build the index on ``device`` (``None``: the card). ``values`` is
        the numeric attribute matrix (n, F), or (n,) for one field.
        ``build_times`` records the seconds of each stage.

        ``shards > 1`` builds and serves over that many shards on
        ``device`` (``distributed.local_plan``): the Vamana link phase runs
        per shard with PQ-approximate navigation
        (``distributed.build_vamana_sharded``; the codebook is trained first
        so ADC distances steer the beam pools, the RobustPrune re-rank stays
        exact, recall within the batched build's ±1%), and the engine comes
        back :meth:`shard`-ed."""
        if shards > 1 and config.builder != "batched":
            raise ValueError(
                "shards > 1 requires builder='batched' (the sharded "
                f"link path), got {config.builder!r}")
        dev = resolve_device(device)
        times: dict = {}
        vectors = np.asarray(vectors, np.float32)
        n, d = vectors.shape
        if d % config.pq_m:
            pad = config.pq_m - d % config.pq_m
            vectors = np.pad(vectors, ((0, 0), (0, pad)))
            d += pad

        t0 = time.perf_counter()
        vec_dev = torch.from_numpy(vectors).to(dev)
        codebook = pq_mod.train_pq(vec_dev, config.pq_m,
                                   iters=config.pq_iters, seed=config.seed)
        codes = pq_mod.encode_pq(codebook, vec_dev)
        graph.sync(dev)
        times["pq_s"] = time.perf_counter() - t0

        if shards > 1:
            adj, medoid = distributed.build_vamana_sharded(
                vectors, distributed.local_plan(shards, dev), config.r,
                config.l_build, config.alpha, seed=config.seed, codes=codes,
                codebook=codebook, stage_times=times)
        elif config.builder == "batched":
            adj, medoid = graph.build_vamana_batched(
                vectors, config.r, config.l_build, config.alpha,
                seed=config.seed, device=dev, timings=times)
        elif config.builder == "reference":
            t0 = time.perf_counter()
            adj, medoid = graph.build_vamana(vectors, config.r,
                                             config.l_build, config.alpha,
                                             seed=config.seed, device=dev)
            times["reference_s"] = time.perf_counter() - t0
        else:
            raise ValueError(f"unknown builder {config.builder!r}")
        t0 = time.perf_counter()
        dense = graph.densify_2hop(adj, config.r_dense, seed=config.seed + 1)
        times["densify_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        eng = cls._assemble(vectors, adj, dense, codes, codebook, medoid,
                            label_offsets, label_flat, n_labels, values,
                            config, dev, blooms=None, bucket_codes=None)
        graph.sync(dev)
        times["records_s"] = time.perf_counter() - t0
        eng.build_times = times
        if shards > 1:
            eng.shard(shards)
        return eng

    @classmethod
    def _assemble(cls, vectors, adj, dense, codes, codebook, medoid,
                  label_offsets, label_flat, n_labels, values, config, dev,
                  blooms, bucket_codes, rec_labels=None, rec_values=None,
                  label_store=None, range_store=None, store=None):
        if label_store is None:
            label_store = build_label_store(
                np.asarray(label_offsets, np.int64),
                np.asarray(label_flat, np.int32), int(n_labels))
        if range_store is None:
            range_store = build_multi_range_store(values)
        if store is None:
            if rec_labels is None:
                rec_labels = padded_vec_labels(label_store,
                                               config.max_labels)
            if rec_values is None:
                rec_values = range_store.values
            store = make_record_store(vectors, adj, dense, rec_labels,
                                      rec_values, dev)
        if blooms is None:
            blooms = label_store.blooms
        if bucket_codes is None:
            bucket_codes = range_store.bucket_codes
        blooms = np.asarray(blooms)
        if blooms.dtype == np.uint32:
            blooms = blooms.view(np.int32)
        bucket_codes = np.asarray(bucket_codes, np.uint8)
        if bucket_codes.ndim == 1:
            bucket_codes = bucket_codes[:, None]
        mem = InMemory(
            blooms=torch.from_numpy(np.ascontiguousarray(blooms)).to(dev),
            bucket_codes=torch.from_numpy(
                np.ascontiguousarray(bucket_codes)).to(dev))
        return cls(store, codes, codebook, mem, label_store, range_store,
                   int(medoid), config)

    @classmethod
    def from_arrays(cls, arrays: dict, config: IndexConfig, device=None,
                    label_store: LabelStore | None = None,
                    range_store: MultiRangeStore | None = None
                    ) -> "FilteredANNEngine":
        """An engine over arrays built elsewhere (the JAX package's state as
        numpy, another port engine's :meth:`arrays`, or a checkpoint):
        ``vectors``, ``neighbors``, ``dense_neighbors``, ``rec_labels``,
        ``rec_values``, ``codes``, ``centroids``, ``medoid``, ``blooms``,
        ``bucket_codes``, and either the raw ``label_offsets``/
        ``label_flat``/``n_labels``/``values`` from which the host label and
        range stores are rebuilt, or the stores themselves
        (``label_store``/``range_store``). A checkpoint taken after inserts
        passes its stores: they keep the build-time bucket bounds, which a
        rebuild from the raw values would not."""
        dev = resolve_device(device)
        a = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.array(v))
             for k, v in arrays.items()}
        vectors = np.asarray(a["vectors"], np.float32)
        centroids = torch.from_numpy(
            np.ascontiguousarray(a["centroids"], np.float32)).to(dev)
        codebook = pq_mod.PQCodebook(centroids=centroids,
                                     dim=int(vectors.shape[1]))
        codes = torch.from_numpy(np.ascontiguousarray(a["codes"])).to(dev)
        return cls._assemble(
            vectors, a["neighbors"], a["dense_neighbors"], codes, codebook,
            int(a["medoid"]), a.get("label_offsets"), a.get("label_flat"),
            a.get("n_labels"), a.get("values"), config, dev,
            blooms=a["blooms"], bucket_codes=a["bucket_codes"],
            rec_labels=a["rec_labels"], rec_values=a["rec_values"],
            label_store=label_store, range_store=range_store)

    @classmethod
    def from_disk(cls, disk_store, arrays: dict, config: IndexConfig,
                  device=None, label_store: LabelStore | None = None,
                  range_store: MultiRangeStore | None = None
                  ) -> "FilteredANNEngine":
        """An engine on the disk backend over an open ``disk_store``
        (``storage.DiskRecordStore``, e.g. a restored checkpoint's slabs):
        ``arrays`` as :meth:`from_arrays` takes them, without the record
        fields, which the slabs hold."""
        dev = resolve_device(device)
        a = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.array(v))
             for k, v in arrays.items()}
        centroids = torch.from_numpy(
            np.ascontiguousarray(a["centroids"], np.float32)).to(dev)
        codebook = pq_mod.PQCodebook(centroids=centroids,
                                     dim=disk_store.layout.dim)
        codes = torch.from_numpy(np.ascontiguousarray(a["codes"])).to(dev)
        eng = cls._assemble(
            None, None, None, codes, codebook, int(a["medoid"]),
            a.get("label_offsets"), a.get("label_flat"), a.get("n_labels"),
            a.get("values"), config, dev, blooms=a["blooms"],
            bucket_codes=a["bucket_codes"], label_store=label_store,
            range_store=range_store, store=disk_store.stub_store(dev))
        eng.attach_disk_store(disk_store)
        return eng

    def arrays(self) -> dict:
        """This engine's state as numpy arrays, in the layout
        :meth:`from_arrays` takes (device backend only: on the disk backend
        the records live in ``disk_store``'s slab files)."""
        if self.disk_store is not None:
            raise ValueError("arrays(): the disk backend's records live in "
                             f"its slab files ({self.disk_store.path}); "
                             "take the arrays before to_disk")
        ls = self.label_store
        s = self.store
        return {
            "vectors": s.vectors.cpu().numpy(),
            "neighbors": s.neighbors.cpu().numpy(),
            "dense_neighbors": s.dense_neighbors.cpu().numpy(),
            "rec_labels": s.rec_labels.cpu().numpy(),
            "rec_values": s.rec_values.cpu().numpy(),
            "codes": self.codes.cpu().numpy(),
            "centroids": self.codebook.centroids.cpu().numpy(),
            "medoid": self.medoid,
            "blooms": self.mem.blooms.cpu().numpy().view(np.uint32),
            "bucket_codes": self.mem.bucket_codes.cpu().numpy(),
            "label_offsets": ls.vec_offsets, "label_flat": ls.vec_labels,
            "n_labels": ls.n_labels,
            "values": self.range_store.values,
        }

    # ------------------------------------------------------------------
    def shard(self, shards: int) -> "FilteredANNEngine":
        """Route the pipelined hop loop through ``shards`` shards on this
        engine's device (``distributed.ShardedSearchRunner`` over
        ``distributed.local_plan``): the record store is split by id range
        (views, no copy), queries row-shard per bucket, and results stay
        bit-identical to the unsharded driver. ``shards in (0, 1)`` reverts
        to unsharded execution. In place; returns self. Requires the device
        backend: the disk tier owns the fetch seam."""
        if shards in (0, 1):
            self._runner = None
            return self
        if self.disk_store is not None:
            raise ValueError(
                "sharded execution requires the device backend: the disk "
                "tier's host fetch already owns the fetch_fn seam "
                "(shard before to_disk, or serve from the device store)")
        self._runner = distributed.ShardedSearchRunner(
            distributed.local_plan(shards, self.device), self.store,
            self.codes, self.codebook, self.mem)
        return self

    @property
    def n_shards(self) -> int:
        """Shards the hop loop spans (1: unsharded)."""
        return self._runner.n_shards if self._runner is not None else 1

    def to_disk(self, path: str, storage_config=None) -> "FilteredANNEngine":
        """Switch this engine to the disk backend (``storage/disk.py``).

        The record tensors are spilled to page-aligned slab files at
        ``path`` and replaced by a 1-row stub carrying only shapes and page
        counts — the device keeps the PQ codes and bloom/bucket words, and
        every record byte flows through the disk store's fetch callable.
        Results are bit-identical to the device backend (the slabs hold the
        same float32/int32 values). In place; returns self."""
        ds = DiskRecordStore.from_record_store(
            path, self.store, n=self.n,
            config=storage_config or StorageConfig())
        self.attach_disk_store(ds)
        return self

    def attach_disk_store(self, disk_store) -> None:
        """Adopt an open ``storage.DiskRecordStore`` (e.g. one over a
        restored checkpoint's slabs) and drop the device record tensors."""
        self.disk_store = disk_store
        self.store = disk_store.stub_store(self.device)
        self._builder = None      # drops its device copy of the records
        self._runner = None       # the disk tier owns the fetch seam now

    def calibrate_io(self) -> "io_sim.IOModel | None":
        """Fit :class:`io_sim.IOModel` from the disk tier's measured read
        samples, replacing the modeled constants for latency reporting.
        Returns the fitted model (None without a disk store or samples)."""
        if self.disk_store is None or not self.disk_store.samples:
            return None
        self.io_model = io_sim.IOModel.calibrate_from_samples(
            self.disk_store.samples,
            page_bytes=self.disk_store.layout.page_bytes)
        return self.io_model

    def insert(self, vectors: np.ndarray, label_offsets: np.ndarray,
               label_flat: np.ndarray, n_labels: int,
               values: np.ndarray) -> np.ndarray:
        """Append records through the incremental batched build path
        (``graph.IncrementalBuilder``): each batch is linked by one final-α
        pass (greedy search from the medoid → batched RobustPrune on the
        ``prune_scan`` kernel → reverse-edge scatter). Returns the new
        record ids, contiguous from ``self.n``.

        The stores are **capacity-padded**, as in the JAX package: device
        tensors are allocated at the builder's geometric capacity (pad rows
        unreachable — no edge points at them; labels -1, values 0, vectors
        0) and new rows are written in place. The host attribute summaries
        extend incrementally; bucket bounds stay fixed unless a skewed
        stream forces a quantile refresh, which re-codes every row. The PQ
        codebook is not retrained: new vectors are encoded against the
        build-time centroids. Holders of a stale ``engine.store`` or
        ``engine.mem`` must re-read them after an insert. Inserts link
        through the batched pipeline whatever ``config.builder`` is, so a
        ``builder='reference'`` graph is mixed after the first insert. The
        disk backend refuses inserts, as ``repro``'s does."""
        cfg = self.config
        if self.disk_store is not None:
            raise NotImplementedError(
                "insert is not supported on the disk backend: slab files "
                "are append-closed in this release — rebuild the index "
                "(or insert on the device backend, then to_disk)")
        vectors = np.asarray(vectors, np.float32)
        m = vectors.shape[0]
        if m == 0:
            return np.zeros(0, np.int64)
        # store.dim exceeds the build-time input dim only by the pq_m
        # alignment pad, so a narrower batch is a caller error
        if not (self.store.dim - cfg.pq_m < vectors.shape[1]
                <= self.store.dim):
            raise ValueError(
                f"vector dim {vectors.shape[1]} does not match index dim "
                f"{self.store.dim} (built from inputs of dim in "
                f"({self.store.dim - cfg.pq_m}, {self.store.dim}])")
        if vectors.shape[1] < self.store.dim:
            vectors = np.pad(
                vectors, ((0, 0), (0, self.store.dim - vectors.shape[1])))
        values = np.asarray(values, np.float32)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape != (m, self.n_fields):
            raise ValueError(
                f"expected ({m}, {self.n_fields}) values, got {values.shape}")
        if self._builder is None:
            self._builder = graph.IncrementalBuilder(
                self.store.vectors[:self.n], self.store.neighbors[:self.n],
                self.medoid,
                ell=cfg.l_build, alpha=cfg.alpha, device=self.device)
        n0 = self.n
        ids = self._builder.add_batch(vectors)

        # host attribute summaries: incremental extension (no rebuild)
        self.label_store = extend_label_store(
            self.label_store, np.asarray(label_offsets, np.int64),
            np.asarray(label_flat, np.int32), int(n_labels))
        self.range_store = self.range_store.append(values)

        self._refresh_padded_stores(n0, m, vectors)
        self.n = n0 + m
        if self._runner is not None:
            # the runner's shards view the old tensors: re-shard over the
            # refreshed stores
            self.shard(self._runner.n_shards)
        return ids

    def _refresh_padded_stores(self, n0: int, m: int, new_vectors):
        """Bring the capacity-padded device tier up to date after a host
        store extend: the m new rows are written in place; a capacity
        growth first reallocates every tensor at the new capacity.
        ``dense_neighbors`` is resampled over the grown graph either way
        (inserts scatter reverse edges into existing rows)."""
        cfg = self.config
        dev = self.device
        cap = self._builder.capacity
        n_new = n0 + m
        adj_dev = self._builder.adjacency_device          # (cap, R)
        dense = torch.from_numpy(graph.densify_2hop(
            adj_dev.cpu().numpy(), cfg.r_dense, seed=cfg.seed + 1)).to(dev)
        # new rows come from the extended label store's CSR slice, which
        # has already deduplicated (vector, label) pairs
        ls = self.label_store
        row_start = int(ls.vec_offsets[n0])
        new_rec_labels = padded_rows_from_csr(
            ls.vec_offsets[n0:] - row_start, ls.vec_labels[row_start:],
            cfg.max_labels)
        new_values = np.stack([s.values[n0:n_new]
                               for s in self.range_store.stores], axis=1)
        new_codes = pq_mod.encode_pq(
            self.codebook, torch.from_numpy(new_vectors).to(dev))
        new_blooms = ls.blooms[n0:n_new].view(np.int32)
        new_buckets = np.stack([s.bucket_codes[n0:n_new]
                                for s in self.range_store.stores], axis=1)

        if self.store.vectors.shape[0] != cap:             # grown
            def pad_to_cap(t, fill):
                out = torch.full((cap,) + tuple(t.shape[1:]), fill,
                                 dtype=t.dtype, device=dev)
                out[:n0] = t[:n0]
                return out

            rec_labels = pad_to_cap(self.store.rec_labels, -1)
            rec_values = pad_to_cap(self.store.rec_values, 0)
            codes = pad_to_cap(self.codes, 0)
            blooms = pad_to_cap(self.mem.blooms, 0)
            buckets = pad_to_cap(self.mem.bucket_codes, 0)
        else:
            rec_labels = self.store.rec_labels
            rec_values = self.store.rec_values
            codes = self.codes
            blooms = self.mem.blooms
            buckets = self.mem.bucket_codes

        graph.write_rows(rec_labels, new_rec_labels, n0)
        graph.write_rows(rec_values, new_values, n0)
        graph.write_rows(codes, new_codes, n0)
        graph.write_rows(blooms, new_blooms, n0)
        if self.range_store.bounds_refreshed:
            # a quantile refresh re-coded EVERY row: replace the column
            # wholesale — mixing two generations of bounds would break the
            # no-false-negative contract of is_member_approx
            buckets = torch.zeros((cap, self.n_fields), dtype=torch.uint8,
                                  device=dev)
            buckets[:n_new] = torch.from_numpy(
                np.ascontiguousarray(self.range_store.bucket_codes)).to(dev)
        else:
            graph.write_rows(buckets, new_buckets, n0)
        self.codes = codes
        self.mem = InMemory(blooms=blooms, bucket_codes=buckets)
        self.store = RecordStore(
            vectors=self._builder.data_device, neighbors=adj_dev,
            dense_neighbors=dense, rec_labels=rec_labels,
            rec_values=rec_values, pages_std=self.store.pages_std,
            pages_dense=self.store.pages_dense,
            # the 2-hop sample was just resampled: re-derive the mask
            cand_first=candidate_first_mask(adj_dev, dense),
            hop_graphs=HopGraphs())

    def approx_scan(self, queries: np.ndarray,
                    selectors: Sequence[Selector],
                    scfgs: Sequence[SearchConfig]):
        """Last-rung degrade execution (serve overload ladder): a gated
        full-corpus ADC scan over the in-memory code tier
        (``prefilter.scan_all_gated``), then exact fetch + verification of
        the top re-rank set — no graph traversal, I/O bounded by the
        re-rank budget.

        Same return shape as :meth:`execute`. Candidate generation is
        approximate (ADC order + superset membership gate over *every* id,
        so no valid record can be excluded), results are exactly verified
        (no false positives), and every query is flagged in
        ``stats.degraded`` with mechanism ``"scan"``."""
        with trace.batch() as tally, trace.span("engine.scan"):
            out_ids, out_d, stats = self._scan(queries, selectors, scfgs)
        stats.trace = tally
        return out_ids, out_d, stats

    def _scan(self, queries, selectors, scfgs):
        queries = np.asarray(queries, np.float32)
        if queries.shape[1] != self.store.dim:
            pad = self.store.dim - queries.shape[1]
            queries = np.pad(queries, ((0, 0), (0, pad)))
        B = queries.shape[0]
        assert len(selectors) == B and len(scfgs) == B
        cfg = self.config
        plans = [s.plan(cfg.ql, cfg.cap, cfg.qr) for s in selectors]
        out_ids: list = [None] * B
        out_d: list = [None] * B
        stats = QueryStats(
            mechanism=["scan"] * B,
            io_pages=np.zeros(B, np.int64), est_io_pages=np.zeros(B),
            dist_comps=np.zeros(B, np.int64), est_compute=np.zeros(B),
            hops=np.zeros(B, np.int64), fp_explored=np.zeros(B, np.int64),
            explored=np.zeros(B, np.int64), n_valid=np.zeros(B, np.int64),
            selectivity=np.array([p.selectivity for p in plans]),
            precision_in=np.array([p.precision_in for p in plans]),
            faults=np.zeros(B, np.int64), retries=np.zeros(B, np.int64),
            degraded=np.ones(B, np.int64))
        if B == 0:
            return out_ids, out_d, stats
        ds = self.disk_store
        disk_before = ds.snapshot() if ds is not None else None
        q_dev = torch.from_numpy(queries).to(self.device)
        qf_dev = filter_to_device(stack_filters([p.qfilter for p in plans]),
                                  self.device)
        for i in range(B):
            scfg = scfgs[i]
            rerank = scan_rerank(scfg)
            qf = QueryFilter(*(x[i:i + 1] for x in qf_dev))
            top_ids, _ = prefilter.scan_all_gated(
                self.codes, self.codebook, self.mem, qf, q_dev[i], rerank)
            pp = prefilter.PrefilterParams(l_rerank=rerank, k=scfg.k)
            if ds is None:
                ids, dists, io, nv = prefilter._rerank_verify(
                    self.store, qf, q_dev[i], top_ids, pp)
            else:
                tid = trace.to_host(top_ids).numpy()
                ids, dists, io, nv = prefilter._verify_fetched(
                    qf, q_dev[i], top_ids,
                    ds.fetch_host(np.where(tid >= 0, tid, 0)), pp,
                    self.store.pages_std)
            est = cost_model.approx_scan_cost(
                self.cost_inputs(plans[i], scfg), rerank)
            out_ids[i] = trace.to_host(ids).numpy()
            out_d[i] = trace.to_host(dists).numpy()
            stats.io_pages[i] = int(io)
            stats.est_io_pages[i] = est.io_pages
            stats.dist_comps[i] = int(self.codes.shape[0])
            stats.est_compute[i] = est.compute
            stats.explored[i] = rerank
            stats.n_valid[i] = int(nv)
        if ds is not None:
            stats.disk = ds.delta(disk_before, ds.snapshot())
        return out_ids, out_d, stats

    # ------------------------------------------------------------------
    def cost_inputs(self, plan, scfg: SearchConfig) -> cost_model.CostInputs:
        """The router's CostInputs for one planned query."""
        return cost_model.CostInputs(
            n=self.n, l=scfg.l, s=plan.selectivity,
            p_pre=plan.precision_pre, p_in=plan.precision_in,
            x_pre=plan.pages_prescan, x_in=plan.pages_prefetch,
            r=self.store.degree,
            r_d=self.store.degree + self.store.dense_degree,
            s_r=self.store.pages_std, s_d=self.store.pages_dense)

    def estimate_cost(self, selector: Selector, scfg: SearchConfig = None,
                      rung: "cost_model.DegradeRung | None" = None) -> float:
        """Modeled service cost of one query (α·pages + β·comps) at the
        routed mechanism, or at a degrade-ladder ``rung``."""
        scfg = scfg or SearchConfig()
        cfg = self.config
        plan = selector.plan(cfg.ql, cfg.cap, cfg.qr)
        c = self.cost_inputs(plan, scfg)
        if rung is not None:
            return cost_model.rung_cost(
                c, rung, scfg.alpha, scfg.beta, scfg.max_pool,
                base_prefetch=scfg.prefetch_depth,
                rerank=scan_rerank(scfg, rung), calib=self.calibration)
        route = self._route(plan, scfg)
        return route.costs[route.mechanism].total(scfg.alpha, scfg.beta)

    def _route(self, plan, scfg: SearchConfig) -> cost_model.Route:
        c = self.cost_inputs(plan, scfg)
        full = cost_model.route_query(c, scfg.alpha, scfg.beta,
                                      scfg.max_pool, calib=self.calibration)
        if plan.force_mech is not None:
            mech = plan.force_mech
        elif scfg.policy == "speculative":
            return full
        elif scfg.policy == "basefilter":
            mech = "pre" if plan.selectivity < 0.01 else "post"
        elif scfg.policy == "strict_in":
            mech = "in"
        elif scfg.policy == "strict_pre":
            mech = "pre"
        elif scfg.policy == "post":
            mech = "post"
        else:
            raise ValueError(scfg.policy)
        strict_in = scfg.policy == "strict_in" and mech == "in"
        eff_l = full.effective_l if (mech == full.mechanism
                                     and not strict_in) else \
            cost_model.effective_l(mech, c, scfg.max_pool, strict=strict_in)
        return cost_model.Route(mech, full.costs, eff_l)

    # ------------------------------------------------------------------
    def execute(self, queries: np.ndarray, selectors: Sequence[Selector],
                scfgs: Sequence[SearchConfig]):
        """The batched request path (paper §4 Fig. 4, generalized).

        Each query carries its own ``SearchConfig``; queries are grouped by
        (mechanism, pool-size bucket, config) and executed as coalesced
        batches. Returns ``(ids_list, dists_list, QueryStats)``;
        ``QueryStats.trace`` is the batch's tally (``utils/trace.py``).
        """
        with trace.batch() as tally, trace.span("engine.execute"):
            out_ids, out_d, stats = self._execute_groups(queries, selectors,
                                                         scfgs)
        stats.trace = tally
        return out_ids, out_d, stats

    def _execute_groups(self, queries, selectors, scfgs):
        queries = np.asarray(queries, np.float32)
        if queries.shape[1] != self.store.dim:
            pad = self.store.dim - queries.shape[1]
            queries = np.pad(queries, ((0, 0), (0, pad)))
        B = queries.shape[0]
        assert len(selectors) == B and len(scfgs) == B
        cfg = self.config

        with trace.span("engine.plan"):
            plans = [s.plan(cfg.ql, cfg.cap, cfg.qr) for s in selectors]
            routes = [self._route(p, sc) for p, sc in zip(plans, scfgs)]

        out_ids: list = [None] * B
        out_d: list = [None] * B
        stats = QueryStats(
            mechanism=[r.mechanism for r in routes],
            io_pages=np.zeros(B, np.int64),
            est_io_pages=np.array(
                [r.costs[r.mechanism].io_pages for r in routes]),
            dist_comps=np.zeros(B, np.int64),
            est_compute=np.array(
                [r.costs[r.mechanism].compute for r in routes]),
            hops=np.zeros(B, np.int64),
            fp_explored=np.zeros(B, np.int64),
            explored=np.zeros(B, np.int64),
            n_valid=np.zeros(B, np.int64),
            selectivity=np.array([p.selectivity for p in plans]),
            precision_in=np.array([p.precision_in for p in plans]),
            faults=np.zeros(B, np.int64),
            retries=np.zeros(B, np.int64),
            degraded=np.zeros(B, np.int64),
        )

        groups: dict = {}
        for i, r in enumerate(routes):
            eff = 1 << max(5, math.ceil(math.log2(max(r.effective_l, 1))))
            eff = min(eff, scfgs[i].max_pool)
            groups.setdefault((r.mechanism, eff, scfgs[i]), []).append(i)
        trace.count(groups=len(groups))

        ds = self.disk_store
        disk_before = ds.snapshot() if ds is not None else None
        for (mech, eff_l, scfg), idxs in groups.items():
            with trace.span("engine.group", mechanism=mech, width=eff_l,
                            rows=len(idxs)):
                self._run_group(queries, selectors, plans, mech, eff_l, scfg,
                                idxs, out_ids, out_d, stats)
        if ds is not None:
            stats.disk = ds.delta(disk_before, ds.snapshot())
        return out_ids, out_d, stats

    def _run_group(self, queries, selectors, plans, mech, eff_l, scfg, idxs,
                   out_ids, out_d, stats) -> None:
        """One (mechanism, pool bucket, config) group of :meth:`execute`:
        its answers and counters go into ``out_ids``, ``out_d``, ``stats``."""
        ds = self.disk_store
        strict = scfg.policy in ("strict_in", "strict_pre", "basefilter")
        sub_q = np.ascontiguousarray(queries[idxs])
        sub_sel = [selectors[i] for i in idxs]
        sub_qf = stack_filters([plans[i].qfilter for i in idxs])
        if ds is not None:
            # arm the disk tier with this group's knobs: the fault plan
            # (its host draws mirror the hop step's ladder) and the
            # read-ahead window (depth - 1 scales it)
            ds.fault_plan = scfg.fault_plan
            ds.prefetch_depth = scfg.prefetch_depth
        if mech == "pre":
            pp = prefilter.PrefilterParams(
                l_rerank=eff_l + scfg.l_rerank_delta, k=scfg.k)
            res = prefilter.prefilter_search(
                self.store, self.codes, self.codebook, sub_sel, sub_qf,
                sub_q, pp, speculative=not strict,
                host_fetch=ds.fetch_host if ds is not None else None)
            ids = trace.to_host(res.ids).numpy()
            dists = trace.to_host(res.dists).numpy()
            io = res.io_pages.numpy()
            dc = res.dist_comps.numpy()
            nv = res.n_valid.numpy()
            for j, i in enumerate(idxs):
                out_ids[i] = ids[j]
                out_d[i] = dists[j]
                stats.io_pages[i] = int(io[j])
                stats.dist_comps[i] = int(dc[j])
                stats.n_valid[i] = int(nv[j])
            return
        mode = {"in": "strict_in" if scfg.policy == "strict_in"
                else "spec_in", "post": "post"}[mech]
        sp = search.SearchParams(
            l_search=eff_l, k=scfg.k, beam_width=scfg.beam_width,
            max_hops=scfg.max_hops, mode=mode, l_valid=scfg.l,
            prefetch_depth=scfg.prefetch_depth,
            fault_plan=scfg.fault_plan)
        entries = None
        seed_pages = np.zeros(len(idxs), np.int64)
        if mode == "strict_in":
            # strict in-filtering needs exactly-valid entry seeds; the
            # attribute-index scan's pages are charged to the query
            ents = np.full((len(idxs), 4), -1, np.int32)
            for j in range(len(idxs)):
                seeds, pages = _strict_seed_ids(sub_sel[j], self.medoid, 4)
                ents[j, :seeds.size] = seeds
                seed_pages[j] = pages
            entries = ents
        res = search.filtered_search_pipelined(
            self.store, self.codes, self.codebook, self.mem, sub_qf,
            sub_q, self.medoid, sp, entries=entries,
            hop_chunk=scfg.hop_chunk,
            fetch_fn=(ds.fetch_callable if ds is not None
                      else search.local_fetch),
            runner=self._runner)      # None on the disk backend
        r = {f: trace.to_host(getattr(res, f)).numpy()
             for f in search.SearchResult._fields}
        # a row's hops count only the steps it was active in
        trace.count(row_hops_live=int(r["hops"].sum()),
                    explored=int(r["explored"].sum()),
                    fp_explored=int(r["fp_explored"].sum()))
        prefetch = np.array([plans[i].pages_prefetch for i in idxs]) \
            if mode == "spec_in" else np.zeros(len(idxs), np.int64)
        for j, i in enumerate(idxs):
            out_ids[i] = r["ids"][j]
            out_d[i] = r["dists"][j]
            stats.io_pages[i] = int(r["io_pages"][j]) + int(
                seed_pages[j]) + int(prefetch[j])
            stats.dist_comps[i] = int(r["dist_comps"][j])
            stats.hops[i] = int(r["hops"][j])
            stats.fp_explored[i] = int(r["fp_explored"][j])
            stats.explored[i] = int(r["explored"][j])
            stats.n_valid[i] = int(r["n_valid"][j])
            stats.faults[i] = int(r["faults"][j])
            stats.retries[i] = int(r["retries"][j])
            stats.degraded[i] = int(r["degraded"][j])

    # ------------------------------------------------------------------
    def search(self, queries: np.ndarray, selectors: Sequence[Selector],
               scfg: SearchConfig = SearchConfig()):
        """Returns (ids (B,k), dists (B,k), QueryStats) — :meth:`execute`
        with one shared SearchConfig."""
        if len(selectors) == 0:
            return (np.zeros((0, scfg.k), np.int32),
                    np.zeros((0, scfg.k), np.float32), QueryStats.empty())
        ids, dists, stats = self.execute(queries, selectors,
                                         [scfg] * len(selectors))
        return (np.stack(ids).astype(np.int32),
                np.stack(dists).astype(np.float32), stats)


def _strict_seed_ids(sel: Selector, medoid: int,
                     e: int) -> tuple[np.ndarray, int]:
    """Entry seeds for strict in-filtering: up to ``e`` exactly-valid
    records, evenly spaced over the attribute index scan, plus the scan's
    page count. Falls back to the medoid when the filter matches nothing."""
    ids, pages = prefilter._strict_scan(sel)
    ids = np.asarray(ids)
    ids = ids[ids >= 0]
    if ids.size == 0:
        return np.array([medoid], np.int32), int(pages)
    take = np.linspace(0, ids.size - 1, num=min(e, ids.size)).astype(np.int64)
    return np.unique(ids[take]).astype(np.int32), int(pages)


BRUTE_CHUNK = 1 << 18     # rows per ground-truth distance block


def brute_force_filtered(vectors: torch.Tensor, rec_labels: torch.Tensor,
                         rec_values: torch.Tensor, qfilter, query,
                         k: int) -> np.ndarray:
    """Exact ground truth on the tensors' device: the top-k valid ids by
    full-precision distance. ``qfilter`` is one query's host QueryFilter."""
    dev = vectors.device
    qf = filter_to_device(stack_filters([qfilter]), dev)
    q = torch.as_tensor(np.asarray(query, np.float32)).to(dev)
    ds = []
    for s in range(0, vectors.shape[0], BRUTE_CHUNK):
        v = vectors[s:s + BRUTE_CHUNK]
        ok = is_member(qf, rec_labels[None, s:s + BRUTE_CHUNK],
                       rec_values[None, s:s + BRUTE_CHUNK])[0]
        d = ((v - q[None, :]) ** 2).sum(1)
        ds.append(torch.where(ok, d, float("inf")))
    d = torch.cat(ds)
    order = torch.sort(d, stable=True).indices[:k]
    order = order[torch.isfinite(d[order])]
    return order.cpu().numpy()


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    gt = set(int(x) for x in gt_ids[:k])
    if not gt:
        return 1.0
    got = set(int(x) for x in result_ids[:k] if x >= 0)
    return len(got & gt) / len(gt)

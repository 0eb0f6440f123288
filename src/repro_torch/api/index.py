"""``Index`` — the public facade over the filtered-ANN engine.

Callers hand over vectors plus one plain metadata dict per record; the
facade owns the attribute :class:`~repro_torch.api.schema.Schema`, the tag
vocabulary, CSR label arrays, attribute stores, and the engine build.
Categorical values (str/int/bool, or lists thereof) become labels in a
per-field namespace; every ``Schema.nums`` field becomes one column of
the dense ``(n, F)`` numeric value matrix — queries may then AND range
predicates over several numeric fields and still compile onto the device
verification path.

The facade is also the DSL compiler's catalog: ``Tag``/``Num`` expressions
resolve against its schema/vocabulary, and results come back with metadata
re-resolved from the attribute stores (so ``save``/``load`` round-trips
need no sidecar record storage).

Counterpart of ``repro.api.index``. The index lives on ``device`` (``None``:
the card). An index built elsewhere — another port index's
``engine.arrays()``, or the JAX package's state as numpy — is wrapped as
``Index(FilteredANNEngine.from_arrays(arrays, config, device), vocab,
schema, defaults)``. Checkpoints are the JAX package's format (``ckpt``), so
an index saved by either package loads in the other, on either backend:
``store="disk"`` serves the records from page-aligned slab files
(``repro_torch.storage``), which a checkpoint carries in ``step_N/slabs``.
``shards > 1`` builds, or loads, an index that serves over that many
shards of its device (``FilteredANNEngine.shard``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.filters import (FilterExpr, _check_fields, compile_expr,
                                     eval_mask)
from repro_torch.api.schema import Schema
from repro_torch.api.types import RequestStats, SearchRequest, SearchResult
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.engine import (FilteredANNEngine, IndexConfig,
                                     QueryStats, SearchConfig,
                                     brute_force_filtered)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.labels import LabelStore
from repro_torch.core.ranges import MultiRangeStore, RangeStore
from repro_torch.core.records import RecordStore
from repro_torch.core.selectors import (MaskSelector, MatchAllSelector,
                                        Selector)
from repro_torch.storage import slab as slab_mod
from repro_torch.storage.disk import DiskRecordStore

_META_FILE = "index_meta.json"
_FORMAT = 2          # checkpoint format: 2 = schema-first multi-field


def _is_numeric(v) -> bool:
    return isinstance(v, (float, np.floating)) and not isinstance(v, bool)


def _norm_tag(v):
    """Canonical (hashable, JSON-able) form of a tag value."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, str):
        return v
    raise TypeError(f"unsupported tag value {v!r} "
                    "(tags must be str/int/bool)")


def _ingest_metadata(metadata: Sequence[dict], schema: Schema,
                     vocab: Optional[dict] = None):
    """Plain per-record dicts -> (vocab, CSR labels, (n, F) values).

    Pass an existing ``vocab`` to extend it in place. The schema is strict:
    every record must carry every numeric field (the value matrix is
    dense), tag fields may be sparse, and keys outside the schema are
    rejected — a live index cannot grow an attribute column retroactively.
    """
    if vocab is None:
        vocab = {}              # (field, value) -> label id
    num_col = {f: j for j, f in enumerate(schema.nums)}
    flat: list = []
    offsets = np.zeros(len(metadata) + 1, np.int64)
    values = np.zeros((len(metadata), schema.n_fields), np.float32)
    for i, d in enumerate(metadata):
        n_tags = 0
        seen: set = set()       # dedupe repeated tags within one record
        for key, v in d.items():
            if key in num_col:
                if (not _is_numeric(v)
                        and not isinstance(v, (int, np.integer))
                        or isinstance(v, bool)):
                    raise ValueError(
                        f"record {i}: numeric field {key!r} holds "
                        f"non-numeric value {v!r}")
                values[i, num_col[key]] = float(v)
                continue
            if key not in schema.tags:
                kind = "numeric" if _is_numeric(v) else "tag"
                raise ValueError(
                    f"record {i}: field {key!r} is not in the index schema "
                    f"(tags={list(schema.tags)}, nums={list(schema.nums)}); "
                    f"a new {kind} field cannot be added to a built index")
            for tag in (v if isinstance(v, (list, tuple, set, frozenset))
                        else (v,)):
                if _is_numeric(tag):
                    raise ValueError(
                        f"record {i}: float value in tag field {key!r} "
                        f"(numeric fields: {list(schema.nums)})")
                pair = (key, _norm_tag(tag))
                if pair in seen:
                    continue
                seen.add(pair)
                lab = vocab.setdefault(pair, len(vocab))
                flat.append(lab)
                n_tags += 1
        for f in schema.nums:
            if f not in d:
                raise ValueError(
                    f"record {i} is missing the numeric field "
                    f"{f!r}; every record needs a value "
                    "(the range store is dense)")
        offsets[i + 1] = offsets[i] + n_tags
    label_flat = np.asarray(flat, np.int32)
    return vocab, offsets, label_flat, values


class Index:
    """Filtered vector index with a declarative, schema-first query surface."""

    def __init__(self, engine: FilteredANNEngine, vocab: dict,
                 schema: Schema,
                 defaults: SearchConfig = SearchConfig()):
        self.engine = engine
        self.vocab = vocab                      # (field, value) -> label id
        self.schema = schema
        self.defaults = defaults
        self._label_names = [None] * len(vocab)  # label id -> (field, value)
        for (field, value), lab in vocab.items():
            self._label_names[lab] = (field, value)

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, vectors: np.ndarray, metadata: Sequence[dict],
              config: IndexConfig = IndexConfig(),
              schema: Optional[Schema] = None,
              numeric_field: Optional[str] = None,
              defaults: SearchConfig = SearchConfig(),
              store: str = "device",
              storage_dir: Optional[str] = None,
              storage_config=None,
              shards: int = 0,
              device=None) -> "Index":
        """Build an index over ``vectors`` + per-record metadata dicts on
        ``device`` (``None``: the card).

        ``schema`` declares the attribute fields explicitly; when omitted
        it is inferred from the metadata (float values ⇒ numeric fields,
        everything else ⇒ tag fields). ``numeric_field`` is the deprecated
        single-field spelling kept from ``repro``: it pins ``Schema.nums``
        to that one field with no inference; pass a Schema instead.

        ``store="disk"`` spills the built records to page-aligned slab
        files at ``storage_dir`` (a temp dir when omitted) and serves every
        record read through the disk tier's page cache — results are
        bit-identical to the device backend. ``storage_config`` is a
        :class:`repro_torch.storage.StorageConfig` (cache size, read-ahead,
        device budget). Inserts require the device backend.

        ``shards > 1`` builds and serves over that many shards of
        ``device`` (``FilteredANNEngine.build(shards=)``): the Vamana link
        phase shards with PQ-approximate navigation and the engine comes
        back sharded, so ``search_batch`` runs the sharded hop loop. Its
        graph differs from ``shards=0``'s (recall within the batched
        build's ±1%); toggling ``engine.shard`` on one index leaves every
        answer equal. The disk backend refuses it.
        """
        if store not in ("device", "disk"):
            raise ValueError(f"unknown store backend {store!r} "
                             "(expected 'device' or 'disk')")
        if shards > 1 and store == "disk":
            raise ValueError("shards > 1 requires the device backend: "
                             "the disk tier owns the fetch seam")
        vectors = np.asarray(vectors, np.float32)
        if len(metadata) != vectors.shape[0]:
            raise ValueError(f"{vectors.shape[0]} vectors but "
                             f"{len(metadata)} metadata dicts")
        if schema is None:
            if numeric_field is not None:
                # legacy spelling: the named field is the one numeric
                # column, every other key is a tag field
                fields = {k for d in metadata for k in d}
                schema = Schema(tags=tuple(sorted(fields
                                                  - {numeric_field})),
                                nums=(numeric_field,))
            else:
                schema = Schema.infer(metadata)
        elif numeric_field is not None:
            raise ValueError("pass either schema= or the deprecated "
                             "numeric_field=, not both")
        vocab, offsets, label_flat, values = _ingest_metadata(metadata,
                                                              schema)
        engine = FilteredANNEngine.build(
            vectors, offsets, label_flat, max(1, len(vocab)), values, config,
            shards=shards, device=device)
        if store == "disk":
            if storage_dir is None:
                storage_dir = tempfile.mkdtemp(prefix="repro_slabs_")
            engine.to_disk(storage_dir, storage_config)
        return cls(engine, vocab, schema, defaults)

    def insert(self, vectors: np.ndarray,
               metadata: Sequence[dict]) -> np.ndarray:
        """Append records to a live index (streaming inserts).

        New nodes are linked through the engine's incremental batched build
        path; tag values unseen at build time extend the vocabulary (the
        schema is fixed — records must carry every ``Schema.nums`` field and
        may not introduce new fields). Returns the assigned record ids
        (contiguous, ``len(index)`` before the call onward). Compiled
        ``Selector`` objects hold the pre-insert attribute stores —
        recompile filters (or use the DSL, which compiles per search) after
        inserting."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise ValueError(f"expected (M, D) vectors, got {vectors.shape}")
        if len(metadata) != vectors.shape[0]:
            raise ValueError(f"{vectors.shape[0]} vectors but "
                             f"{len(metadata)} metadata dicts")
        if vectors.shape[0] == 0:
            return np.zeros(0, np.int64)
        new_vocab, offsets, label_flat, values = _ingest_metadata(
            metadata, self.schema, vocab=dict(self.vocab))
        ids = self.engine.insert(vectors, offsets, label_flat,
                                 max(1, len(new_vocab)), values)
        # commit the vocabulary only after the engine accepted the batch
        self.vocab = new_vocab
        self._label_names.extend([None] * (len(new_vocab)
                                           - len(self._label_names)))
        for (field, value), lab in new_vocab.items():
            if self._label_names[lab] is None:
                self._label_names[lab] = (field, value)
        return ids

    # -- persistence -----------------------------------------------------
    def _array_tree(self) -> dict:
        """Checkpoint leaves (format 2), as numpy arrays. Device tensors are
        trimmed to the valid record count — capacity pads are a live-index
        artifact, not index state. Per-field range structures save stacked:
        (F, n) sorted indexes, (F, B+1) bounds, (F, Q) quantiles, (n, F)
        values and codes. Bloom words are the host label store's uint32.
        On the disk backend the records are not leaves: ``save`` copies the
        slab files beside them."""
        e = self.engine
        n = e.n
        ls, rs = e.label_store, e.range_store

        def host(t):
            return t[:n].cpu().numpy()

        if e.disk_store is not None:
            store_leaves = {}
        else:
            store_leaves = {
                "store_vectors": host(e.store.vectors),
                "store_neighbors": host(e.store.neighbors),
                "store_dense_neighbors": host(e.store.dense_neighbors),
                "store_rec_labels": host(e.store.rec_labels),
                "store_rec_values": host(e.store.rec_values),
            }
        return {
            **store_leaves,
            "pq_codes": host(e.codes),
            "pq_centroids": e.codebook.centroids.cpu().numpy(),
            "ls_vec_offsets": ls.vec_offsets, "ls_vec_labels": ls.vec_labels,
            "ls_inv_offsets": ls.inv_offsets,
            "ls_inv_postings": ls.inv_postings,
            "ls_label_counts": ls.label_counts, "ls_blooms": ls.blooms,
            "rs_values": rs.values,
            "rs_sorted_values": np.stack([s.sorted_values
                                          for s in rs.stores]),
            "rs_sorted_ids": np.stack([s.sorted_ids for s in rs.stores]),
            "rs_bucket_bounds": np.stack([s.bucket_bounds
                                          for s in rs.stores]),
            "rs_bucket_codes": rs.bucket_codes,
            "rs_quantiles": np.stack([s.quantiles for s in rs.stores]),
        }

    def save(self, path: str, injector=None):
        """Persist through ``ckpt`` (atomic step dir + manifest) plus a JSON
        sidecar for the schema, vocabulary and static config.

        Steps increment per save and the last two are kept, so a save that
        lands corrupted still leaves the previous intact step for ``load``
        to fall back to. The sidecar is written at the root (newest wins)
        and inside the step dir: array shapes differ across steps after
        inserts, so a fallback reads the meta of the step it restores.
        ``injector`` (``core.faults.FaultInjector``) makes leaf writes
        flaky. On the disk backend the slab files are copied into
        ``step_N/slabs`` and their sha256 rides the meta, which is written
        after the copy: a save cut mid-copy leaves a step without meta, and
        ``load`` falls back to the previous one."""
        tree = self._array_tree()
        prev = ckpt.latest_step(path)
        step = 0 if prev is None else prev + 1
        ckpt.save(path, step=step, tree=tree, async_write=False,
                  keep_last=2, injector=injector)
        e = self.engine
        slab_meta = {}
        if e.disk_store is not None:
            slab_dir = os.path.join(path, f"step_{step}", "slabs")
            os.makedirs(slab_dir, exist_ok=True)
            for fn in (slab_mod.SLAB_FILE, slab_mod.META_FILE):
                shutil.copy2(os.path.join(e.disk_store.path, fn),
                             os.path.join(slab_dir, fn))
            slab_meta = {
                "backend": "disk",
                "slab_sha256": ckpt.file_digest(
                    os.path.join(slab_dir, slab_mod.SLAB_FILE)),
            }
        meta = {
            "format": _FORMAT,
            **slab_meta,
            "config": dataclasses.asdict(e.config),
            "defaults": dataclasses.asdict(self.defaults),
            "medoid": int(e.medoid),
            "schema": self.schema.to_json(),
            "codebook_dim": int(e.codebook.dim),
            "pages_std": int(e.store.pages_std),
            "pages_dense": int(e.store.pages_dense),
            "n_labels": int(e.label_store.n_labels),
            "k_hashes": int(e.label_store.k_hashes),
            "vocab": [[f, v, lab] for (f, v), lab in self.vocab.items()],
            "arrays": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in tree.items()},
        }
        for meta_path in (os.path.join(path, _META_FILE),
                          os.path.join(path, f"step_{step}", _META_FILE)):
            with open(meta_path, "w") as fh:
                json.dump(meta, fh)

    @classmethod
    def load(cls, path: str, shards: int = 0, device=None) -> "Index":
        """Load a saved index onto ``device`` (``None``: the card),
        recovering from corrupted steps.

        Stale ``step_K.tmp`` dirs are reaped first. Steps are then tried
        newest-first: one that fails integrity verification (checksum
        mismatch, truncated leaf, shape/dtype drift) is quarantined as
        ``step_K.quarantined`` and the previous step is restored instead;
        only when no intact step remains does the error propagate. Format-1
        checkpoints (one numeric field, flat range arrays) load through
        :func:`_shim_legacy_checkpoint`. A checkpoint of the disk backend
        serves from its ``step_N/slabs``, whose sha256 is checked against
        the meta first (a mismatch is a corrupted step). ``shards > 1``
        re-shards the restored device-backend engine
        (:meth:`FilteredANNEngine.shard`; a disk checkpoint raises):
        checkpoints carry no shard state, so the shard count is a load-time
        serving choice."""
        ckpt.reap_tmp(path)
        steps = sorted(ckpt._list_steps(path), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps in {path}")
        t = meta = None
        for n_try, step in enumerate(steps):
            # per-step sidecar when present (array shapes track the step);
            # the root sidecar only describes the newest save
            meta_fn = os.path.join(path, f"step_{step}", _META_FILE)
            if not os.path.exists(meta_fn):
                meta_fn = os.path.join(path, _META_FILE)
            try:
                with open(meta_fn) as fh:
                    meta = json.load(fh)
                target = {k: ckpt.ArraySpec(tuple(v["shape"]),
                                            np.dtype(v["dtype"]))
                          for k, v in meta["arrays"].items()}
                t = ckpt.restore(path, step, target)
                if meta.get("backend") == "disk":
                    sl = os.path.join(path, f"step_{step}", "slabs",
                                      slab_mod.SLAB_FILE)
                    if ckpt.file_digest(sl) != meta.get("slab_sha256"):
                        raise ckpt.CheckpointCorruptionError(
                            f"step {step}: slab file checksum mismatch")
                break
            except (ckpt.CheckpointCorruptionError, json.JSONDecodeError,
                    OSError):
                ckpt.quarantine(path, step)
                if n_try == len(steps) - 1:
                    raise
        if meta.get("format", 1) < 2:
            t, meta = _shim_legacy_checkpoint(t, meta)

        ds = None
        if meta.get("backend") == "disk":
            ds = DiskRecordStore(os.path.join(path, f"step_{step}", "slabs"))
            n_rec = ds.n
        else:
            n_rec = t["store_vectors"].shape[0]
        label_store = LabelStore(
            n_vectors=n_rec, n_labels=meta["n_labels"],
            vec_offsets=t["ls_vec_offsets"], vec_labels=t["ls_vec_labels"],
            inv_offsets=t["ls_inv_offsets"],
            inv_postings=t["ls_inv_postings"],
            label_counts=t["ls_label_counts"], blooms=t["ls_blooms"],
            k_hashes=meta["k_hashes"])
        range_store = MultiRangeStore([
            RangeStore(
                n_vectors=n_rec, values=t["rs_values"][:, j],
                sorted_values=t["rs_sorted_values"][j],
                sorted_ids=t["rs_sorted_ids"][j],
                bucket_bounds=t["rs_bucket_bounds"][j],
                bucket_codes=t["rs_bucket_codes"][:, j],
                quantiles=t["rs_quantiles"][j])
            for j in range(t["rs_values"].shape[1])])
        config = dict(meta["config"])
        arrays = {"codes": t["pq_codes"], "centroids": t["pq_centroids"],
                  "medoid": meta["medoid"], "blooms": label_store.blooms,
                  "bucket_codes": range_store.bucket_codes}
        if ds is not None:
            engine = FilteredANNEngine.from_disk(
                ds, arrays, IndexConfig(**config), device=device,
                label_store=label_store, range_store=range_store)
        else:
            engine = FilteredANNEngine.from_arrays(
                {**arrays, "vectors": t["store_vectors"],
                 "neighbors": t["store_neighbors"],
                 "dense_neighbors": t["store_dense_neighbors"],
                 "rec_labels": t["store_rec_labels"],
                 "rec_values": t["store_rec_values"]},
                IndexConfig(**config), device=device,
                label_store=label_store, range_store=range_store)
        if shards > 1:
            engine.shard(shards)   # raises on the disk backend
        vocab = {(f, v): lab for f, v, lab in meta["vocab"]}
        defaults = dict(meta["defaults"])
        if isinstance(defaults.get("fault_plan"), dict):
            # dataclasses.asdict flattened the plan into a nested dict
            defaults["fault_plan"] = FaultPlan.from_json(
                defaults["fault_plan"])
        return cls(engine, vocab, Schema.from_json(meta["schema"]),
                   SearchConfig(**defaults))

    # -- catalog duck type (used by the filter compiler) ----------------
    @property
    def label_store(self) -> LabelStore:
        return self.engine.label_store

    @property
    def range_store(self) -> MultiRangeStore:
        return self.engine.range_store

    @property
    def store(self) -> RecordStore:
        return self.engine.store

    @property
    def config(self) -> IndexConfig:
        return self.engine.config

    @property
    def n_vectors(self) -> int:
        return self.engine.n

    @property
    def ql(self) -> int:
        return self.engine.config.ql

    @property
    def qr(self) -> int:
        return self.engine.config.qr

    @property
    def numeric_field(self) -> Optional[str]:
        """Deprecated single-field accessor: the first schema numeric
        field (None when the index has none). Use ``index.schema.nums``."""
        return self.schema.nums[0] if self.schema.nums else None

    def label_id(self, field: str, value) -> Optional[int]:
        try:
            return self.vocab.get((field, _norm_tag(value)))
        except TypeError:
            return None

    def __len__(self) -> int:
        return self.n_vectors

    @property
    def dim(self) -> int:
        return self.engine.store.dim

    # -- metadata resolution --------------------------------------------
    def record_metadata(self, rec_id: int) -> dict:
        """Re-resolve one record's metadata dict from the attribute stores.

        Multi-valued tag fields come back as sorted lists."""
        out: dict = {}
        for lab in self.label_store.labels_of(rec_id):
            field, value = self._label_names[int(lab)]
            if field in out:
                prev = out[field] if isinstance(out[field], list) \
                    else [out[field]]
                out[field] = sorted(prev + [value], key=repr)
            else:
                out[field] = value
        for j, field in enumerate(self.schema.nums):
            out[field] = float(
                self.range_store.field_store(j).values[rec_id])
        return out

    # -- query path ------------------------------------------------------
    def compile_filter(self, f) -> Selector:
        if f is None:
            return MatchAllSelector(self.n_vectors)
        if isinstance(f, Selector):
            return f
        return compile_expr(f, self)

    def _resolve_scfg(self, request: SearchRequest) -> SearchConfig:
        over = request.overrides()
        return dataclasses.replace(self.defaults, **over) if over \
            else self.defaults

    def search_batch(self, requests: Sequence[SearchRequest],
                     with_stats: bool = False,
                     with_metadata: bool = True,
                     scfgs: Optional[Sequence[SearchConfig]] = None):
        """Execute a batch through the grouped request path.

        Returns list[SearchResult] (plus the raw batched QueryStats when
        ``with_stats``). ``with_metadata=False`` skips the host-side
        per-hit metadata resolution (benchmark timing paths). ``scfgs``
        replaces the per-request config resolution wholesale — the serve
        tier's degrade ladder passes rung-adjusted configs here while the
        requests themselves stay untouched."""
        if not requests:
            return ([], QueryStats.empty()) if with_stats else []
        queries, selectors, scfgs = self._prepare(requests, scfgs)
        ids, dists, stats = self.engine.execute(queries, selectors, scfgs)
        return self._assemble(requests, ids, dists, stats, with_stats,
                              with_metadata)

    def approx_scan_batch(self, requests: Sequence[SearchRequest],
                          with_stats: bool = False,
                          with_metadata: bool = True,
                          scfgs: Optional[Sequence[SearchConfig]] = None):
        """Execute a batch through the last-rung degrade path (gated
        full-corpus ADC scan + exact verify — ``engine.approx_scan``).
        Same surface as :meth:`search_batch`; results are flagged via
        ``stats.degraded``."""
        if not requests:
            return ([], QueryStats.empty()) if with_stats else []
        queries, selectors, scfgs = self._prepare(requests, scfgs)
        ids, dists, stats = self.engine.approx_scan(queries, selectors,
                                                    scfgs)
        return self._assemble(requests, ids, dists, stats, with_stats,
                              with_metadata)

    def _prepare(self, requests, scfgs):
        queries = np.stack([np.asarray(r.query, np.float32).reshape(-1)
                            for r in requests])
        if queries.shape[1] > self.dim:
            raise ValueError(f"query dim {queries.shape[1]} exceeds index "
                             f"dim {self.dim}")
        selectors = [self.compile_filter(r.filter) for r in requests]
        if scfgs is None:
            scfgs = [self._resolve_scfg(r) for r in requests]
        else:
            scfgs = list(scfgs)
            assert len(scfgs) == len(requests)
        return queries, selectors, scfgs

    def _assemble(self, requests, ids, dists, stats, with_stats,
                  with_metadata):
        results = []
        for i in range(len(requests)):
            meta = [self.record_metadata(int(x))
                    if with_metadata and x >= 0 else None
                    for x in ids[i]]
            results.append(SearchResult(
                ids=np.asarray(ids[i]), dists=np.asarray(dists[i]),
                metadata=meta,
                stats=RequestStats.from_query_stats(stats, i)))
        return (results, stats) if with_stats else results

    def search(self, request: SearchRequest) -> SearchResult:
        return self.search_batch([request])[0]

    def ground_truth(self, request: SearchRequest) -> np.ndarray:
        """Exact filtered top-k ids by brute force (for recall evaluation).

        A DSL filter (or none) is evaluated exactly on the host with numpy,
        as ``repro`` does, so the ids equal ``repro``'s; a raw ``Selector``
        is verified on the index's device
        (``engine.brute_force_filtered``). On the disk backend the records
        are streamed off the slab files (``DiskRecordStore.scan_records``,
        which bypasses the page cache)."""
        k = request.k if request.k is not None else self.defaults.k
        n = self.n_vectors
        q = np.asarray(request.query, np.float32).reshape(-1)
        if q.shape[0] > self.dim:
            raise ValueError(f"query dim {q.shape[0]} exceeds index "
                             f"dim {self.dim}")
        if q.shape[0] != self.dim:
            q = np.pad(q, (0, self.dim - q.shape[0]))
        f = request.filter
        ds = self.engine.disk_store
        if ds is not None:
            recs = {k: torch.from_numpy(v).to(self.engine.device)
                    for k, v in ds.scan_records(0, n).items()}
        else:
            s = self.store
            recs = {"vectors": s.vectors[:n], "rec_labels": s.rec_labels[:n],
                    "rec_values": s.rec_values[:n]}
        if f is None or isinstance(f, FilterExpr):
            if f is not None:
                _check_fields(f, self)
            mask, _ = eval_mask(f, self)
        elif isinstance(f, MaskSelector):
            mask = np.zeros(n, bool)
            mask[f.valid_ids] = True
        elif isinstance(f, Selector):
            plan = f.plan(self.config.ql, self.config.cap, self.config.qr)
            return brute_force_filtered(recs["vectors"], recs["rec_labels"],
                                        recs["rec_values"], plan.qfilter, q,
                                        k)
        else:
            raise TypeError(f"unsupported filter {f!r}")
        vecs = recs["vectors"].cpu().numpy()
        d = np.sum((vecs - q[None, :]) ** 2, axis=1)
        d = np.where(mask, d, np.inf)
        order = np.argsort(d)[:k]
        return order[np.isfinite(d[order])]


def _shim_legacy_checkpoint(t: dict, meta: dict) -> tuple[dict, dict]:
    """Map a format-1 (single numeric field) checkpoint onto F=1 arrays.

    Legacy layout: ``store_rec_values``/``rs_values``/``rs_bucket_codes``
    are flat ``(n,)``, per-field structures have no leading F axis, and the
    sidecar names a ``numeric_field`` instead of a schema. Tag fields are
    reconstructed from the vocabulary (legacy metas stored no field list).
    """
    t = dict(t)
    meta = dict(meta)
    for key in ("store_rec_values", "rs_values", "rs_bucket_codes"):
        if t[key].ndim == 1:
            t[key] = t[key][:, None]
    for key in ("rs_sorted_values", "rs_sorted_ids", "rs_bucket_bounds",
                "rs_quantiles"):
        if t[key].ndim == 1:
            t[key] = t[key][None]
    numeric_field = meta.pop("numeric_field", None)
    tag_fields = sorted({f for f, _, _ in meta["vocab"]})
    meta["schema"] = {"tags": tag_fields,
                      "nums": [numeric_field] if numeric_field else []}
    meta["format"] = _FORMAT
    return t, meta

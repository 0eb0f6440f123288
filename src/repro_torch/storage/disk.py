"""DiskRecordStore — the disk tier behind the search loop's fetch hook.

Counterpart of ``repro.storage.disk``. Tiers:

* **device**: PQ codes, bloom/bucket words (``InMemory``) and the search
  state — everything the hop loop touches per candidate *before* paying
  a page read;
* **host**: the page cache (``cache.PageCache``), the pinned staging
  buffers of the fetch results, and the attribute summaries (label
  postings, sorted range indexes);
* **disk**: page-aligned record slabs (``slab.py``), read with
  ``os.pread`` and timed per run — the samples feed
  ``IOModel.calibrate_from_samples``.

The search loop never sees this class directly: it calls a *fetch
callable* (:attr:`DiskRecordStore.fetch_callable`) whose ``wants_ctx``
attribute opts it into the extended fetch protocol of ``core/search.py``
— per-row hop counters (for fault draws), liveness (dead rows skip
I/O), and, on strict-mode attribute probes, a **bloom/bucket gate
computed on the device tier before any page is read**: a candidate whose
approximate membership is already False returns poisoned attributes
(labels −1, values NaN) without touching disk. The gate is a
no-false-negative superset, so exact verification would have rejected
the row anyway — results stay bit-identical to the all-resident backend
while ``gated_skips / attr_probes`` measures the paper's saved I/O.

``repro`` bridges the jitted hop loop to this store with an
``io_callback``; the port's hop loop runs on the host, so the callable is
called directly: the hop loop packs the ids and two context rows
(hops/liveness, or need/gate) into one int32 tensor, which the callable
copies to the host in one transfer; it reads, and copies the fields back
to the search's device through pinned staging buffers (:class:`_Staging`),
into the buffers the caller passes as ``out`` where it passes them (a
replayed hop's static record buffers, ``core/search.py``).

Fault routing: when a :class:`~repro_torch.core.faults.FaultPlan` is armed,
frontier reads draw the *same* stateless (record id, hop, attempt)
hashes as the hop step's retry→hedge→degrade ladder
(``read_attempt_bad_np`` is the bit-identical NumPy twin), so a drawn
failure here raises a real ``InjectedReadError`` / CRC mismatch, the retry
genuinely re-reads the pages (cache invalidated first), and a row that exhausts the ladder
returns zeros exactly where the hop step substitutes its ADC fallback —
degraded rows never have their disk bytes consumed.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.faults import FaultPlan
from repro_torch.core.records import (HopGraphs, RecordStore,
                                      candidate_first_mask)
from repro_torch.storage import slab as slab_mod
from repro_torch.storage.cache import PageCache
from repro_torch.storage.slab import (InjectedReadError, SlabChecksumError,
                                      SlabLayout, SLAB_FILE, read_meta)
from repro_torch.utils import trace

_MAX_SAMPLES = 4096


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """Knobs for the disk tier (facade: ``Index.build(store="disk")``)."""
    cache_pages: int = 4096            # page-cache capacity (4 KB frames)
    readahead_per_record: int = 4      # neighbor slabs prefetched per
                                       # fetched record, × (depth − 1)
    readahead_batch_cap: int = 64      # max read-ahead pages per fetch call


class _Counters:
    # the last two, host µs: fetch_us sums the ``disk.fetch`` span's
    # seconds over the fetches records_fetched counts (track=True; page
    # reads included), pread_us every read's µs, of which ``samples``
    # keeps only the first _MAX_SAMPLES
    FIELDS = ("pages_read", "preads", "records_fetched", "attr_probes",
              "attr_reads", "gated_skips", "readahead_pages", "faults",
              "retries", "degraded", "fetch_us", "pread_us")

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}


class _Staging:
    """Pinned host buffers for the fetch results' copies to the card, one
    set reused by every fetch. Reuse is ordered by the fetch itself: each
    call starts with a blocking ``.cpu()`` of its ids on the same stream,
    which returns only after the previous fetch's non-blocking copies out
    of these buffers have finished. On the CPU the fetched arrays are
    wrapped as they are."""

    def __init__(self):
        self._bufs: dict = {}

    def _pinned(self, k: str, a: np.ndarray) -> torch.Tensor:
        b = self._bufs.get(k)
        if b is None or tuple(b.shape) != a.shape or \
                b.numpy().dtype != a.dtype:
            b = torch.from_numpy(a).pin_memory()
            self._bufs[k] = b
        else:
            b.numpy()[...] = a
        return b

    def to_device(self, arrays: dict, dev: torch.device,
                  out: dict | None = None) -> dict:
        """The arrays as tensors on ``dev``: copied into ``out``'s tensors
        of the same keys (non-blocking on the card) where it is given,
        else new tensors."""
        on_card = dev.type == "cuda"
        got = {}
        for k, a in arrays.items():
            src = self._pinned(k, a) if on_card else torch.from_numpy(a)
            if out is not None:
                got[k] = out[k].copy_(src, non_blocking=on_card)
            else:
                got[k] = src.to(dev, non_blocking=True) if on_card else src
        return got


class _DiskFetch:
    """The hop loop's fetch callable, marked ``wants_ctx`` so the hop loop
    passes each id's context (``core/search.py``): ``packed`` is one
    (3, n) int32 tensor, the ids over two context rows, each row's hop
    counter and liveness for a frontier fetch (with ``dense``), ``need``
    and ``gate`` for a strict_in attribute probe (``attrs_only``). The
    fields come back in new tensors, or in ``out``'s where it is given."""
    wants_ctx = True

    def __init__(self, ds: "DiskRecordStore"):
        self._ds = ds
        self._stage = _Staging()

    def __call__(self, store: RecordStore, packed: torch.Tensor, *,
                 dense: bool = True, attrs_only: bool = False,
                 out: dict | None = None) -> dict:
        ds = self._ds
        ids, ctx1, ctx2 = trace.to_host(packed).numpy()
        if attrs_only:
            got = ds.read_attrs(ids, ctx1.astype(bool), ctx2.astype(bool))
        else:
            got = ds.fetch(ids, ctx1, ctx2.astype(bool), dense=bool(dense))
        return self._stage.to_device(got, packed.device, out)


class DiskRecordStore:
    """Slab-file record store with a clock page cache and measured I/O."""

    def __init__(self, path: str, config: StorageConfig = StorageConfig()):
        self.path = path
        self.config = config
        meta = read_meta(path)
        self.meta = meta
        self.layout: SlabLayout = SlabLayout.from_json(meta["layout"])
        self.n = int(meta["n"])
        self.pages_std = int(meta["pages_std"])
        self.pages_dense = int(meta["pages_dense"])
        self._fd = os.open(os.path.join(path, SLAB_FILE), os.O_RDONLY)
        self.cache = PageCache(config.cache_pages)
        self.counters = _Counters()
        self.samples: list = []        # {"pages", "us", "kind"} measurements
        self.fault_plan: FaultPlan | None = None
        self.prefetch_depth: int = 2
        self.fetch_callable = _DiskFetch(self)

    # -- lifecycle -------------------------------------------------------
    @classmethod
    def create(cls, path: str, vectors, neighbors, dense_neighbors,
               rec_labels, rec_values, cand_first, pages_std: int,
               pages_dense: int,
               config: StorageConfig = StorageConfig()) -> "DiskRecordStore":
        slab_mod.write_slab_file(
            path, np.asarray(vectors, np.float32),
            np.asarray(neighbors, np.int32),
            np.asarray(dense_neighbors, np.int32),
            np.asarray(rec_labels, np.int32),
            np.asarray(rec_values, np.float32),
            np.asarray(cand_first, bool), pages_std, pages_dense)
        return cls(path, config)

    @classmethod
    def from_record_store(cls, path: str, store: RecordStore,
                          n: int | None = None,
                          config: StorageConfig = StorageConfig()
                          ) -> "DiskRecordStore":
        """Spill a :class:`RecordStore` of tensors to slabs (rows may be
        capacity-padded; ``n`` trims to the live prefix)."""
        n = store.n if n is None else n
        cf = store.cand_first
        if cf is None:
            cf = candidate_first_mask(store.neighbors[:n],
                                      store.dense_neighbors[:n])

        def host(t):
            return t[:n].cpu().numpy()

        return cls.create(
            path, host(store.vectors), host(store.neighbors),
            host(store.dense_neighbors), host(store.rec_labels),
            host(store.rec_values), host(cf), store.pages_std,
            store.pages_dense, config)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):                          # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    # -- device-tier stub ------------------------------------------------
    def stub_store(self, device="cpu") -> RecordStore:
        """A 1-row :class:`RecordStore` on ``device`` carrying only shapes
        and the modeled page counts — the device tier holds no record data;
        every record byte the search consumes flows through the fetch
        callable — and an empty cache of the hop loop's CUDA graphs, whose
        replays call the fetch callable between them."""
        lo = self.layout

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        return RecordStore(
            vectors=full((1, lo.dim), 0.0, torch.float32),
            neighbors=full((1, lo.r), -1, torch.int32),
            dense_neighbors=full((1, lo.r_dense), -1, torch.int32),
            rec_labels=full((1, lo.max_labels), -1, torch.int32),
            rec_values=full((1, lo.n_fields), 0.0, torch.float32),
            pages_std=self.pages_std, pages_dense=self.pages_dense,
            cand_first=full((1, lo.r + lo.r_dense), False, torch.bool),
            hop_graphs=HopGraphs())

    @property
    def file_bytes(self) -> int:
        return int(self.meta["file_bytes"])

    def stub_bytes(self) -> int:
        """Device-resident record bytes under the disk backend (the stub)."""
        s = self.stub_store()
        return sum(t.numel() * t.element_size() for t in
                   (s.vectors, s.neighbors, s.dense_neighbors, s.rec_labels,
                    s.rec_values, s.cand_first))

    # -- page I/O --------------------------------------------------------
    def _read_run(self, first_pid: int, n_pages: int,
                  readahead: bool) -> bytes:
        pb = self.layout.page_bytes
        t0 = time.perf_counter()
        data = os.pread(self._fd, n_pages * pb, first_pid * pb)
        us = (time.perf_counter() - t0) * 1e6
        self.counters.pread_us += us
        self.counters.preads += 1
        self.counters.pages_read += n_pages
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append({"pages": n_pages, "us": us,
                                 "kind": "serial"})
        if len(data) != n_pages * pb:
            raise IOError(f"short read at page {first_pid}")
        for i in range(n_pages):
            self.cache.put(first_pid + i, data[i * pb:(i + 1) * pb],
                           readahead=readahead)
        return data

    def _get_pages(self, pids: list, readahead: bool = False) -> dict:
        """pid → page bytes, filling misses with contiguous pread runs."""
        out, missing = {}, []
        for pid in pids:
            hit = self.cache.get(pid)
            if hit is None:
                missing.append(pid)
            else:
                out[pid] = hit
        missing.sort()
        pb = self.layout.page_bytes
        i = 0
        while i < len(missing):
            j = i
            while j + 1 < len(missing) and missing[j + 1] == missing[j] + 1:
                j += 1
            run = self._read_run(missing[i], j - i + 1, readahead)
            for k, pid in enumerate(missing[i:j + 1]):
                out[pid] = run[k * pb:(k + 1) * pb]
            i = j + 1
        return out

    def _slab_page_ids(self, rid: int, dense: bool) -> list:
        lo = self.layout
        base = rid * lo.slab_pages
        n = lo.slab_pages if (dense and lo.dense_pages) else lo.std_pages
        return [base + i for i in range(n)]

    def _read_record(self, rid: int, dense: bool,
                     corrupt: bool = False) -> dict:
        """One record through the cache; CRC-verified decode. ``corrupt``
        flips a byte post-read (in-flight corruption) so the checksum
        path genuinely fires."""
        lo = self.layout
        pids = self._slab_page_ids(rid, dense)
        pages = self._get_pages(pids)
        std = b"".join(pages[p] for p in pids[:lo.std_pages])
        if corrupt:
            std = bytes([std[0] ^ 0xFF]) + std[1:]
        rec = slab_mod.decode_std(lo, std)
        if dense and lo.dense_pages:
            dblk = b"".join(pages[p] for p in pids[lo.std_pages:])
            rec["dense_neighbors"] = slab_mod.decode_dense(lo, dblk)
        else:
            rec["dense_neighbors"] = np.full(lo.r_dense, -1, np.int32)
        return rec

    # -- fetch (frontier records) ---------------------------------------
    def fetch(self, ids: np.ndarray, hops: np.ndarray | None = None,
              live: np.ndarray | None = None, dense: bool = True,
              track: bool = True) -> dict:
        """Batch record fetch with the fault ladder and read-ahead.

        Dead rows (``live`` False) are skipped — the hop loop fully masks
        them downstream, so zeros are never consumed. Returns a dict of
        numpy arrays with ``search.local_fetch``'s fields. ``track=False``
        leaves the fetch counters, the latency samples and read-ahead out
        (page reads and the cache still count).
        """
        with trace.span("disk.fetch") as sp:
            out = self._fetch(ids, hops, live, dense, track)
        if track:
            self.counters.fetch_us += sp.dt * 1e6
        return out

    def _fetch(self, ids, hops, live, dense: bool, track: bool) -> dict:
        ids = np.asarray(ids, np.int64).reshape(-1)
        n = ids.size
        lo = self.layout
        out = {
            "vectors": np.zeros((n, lo.dim), np.float32),
            "neighbors": np.full((n, lo.r), -1, np.int32),
            "dense_neighbors": np.full((n, lo.r_dense), -1, np.int32),
            "rec_labels": np.full((n, lo.max_labels), -1, np.int32),
            "rec_values": np.zeros((n, lo.n_fields), np.float32),
            "cand_first": np.zeros((n, lo.r + lo.r_dense), bool),
        }
        live = np.ones(n, bool) if live is None else \
            np.asarray(live, bool).reshape(-1)
        plan = self.fault_plan
        faulted = (plan is not None and plan.reads_faulty
                   and hops is not None)
        if faulted:
            hops = np.asarray(hops, np.int64).reshape(-1)
            fail, corrupt = _attempt_draws(ids, hops, plan)
        pages_before = self.counters.pages_read
        t0 = time.perf_counter()
        n_live = 0
        for i in range(n):
            if not live[i]:
                continue
            n_live += 1
            rid = int(ids[i])
            rec = None
            if not faulted:
                rec = self._read_record(rid, dense)
            else:
                for a in range(plan.attempts):
                    if a > 0:
                        self.counters.retries += 1
                        self.cache.invalidate(self._slab_page_ids(rid,
                                                                  dense))
                    try:
                        if fail[a, i]:
                            # the read was issued and the pages transferred
                            # before the device reported failure — charge
                            # them, then walk the ladder
                            self._read_record(rid, dense)
                            raise InjectedReadError(
                                f"injected read failure: record {rid}")
                        rec = self._read_record(rid, dense,
                                                corrupt=bool(corrupt[a, i]))
                        break
                    except (InjectedReadError, SlabChecksumError):
                        self.counters.faults += 1
                        self.cache.invalidate(self._slab_page_ids(rid,
                                                                  dense))
                        rec = None
                if rec is None:
                    # ladder exhausted: the hop step substitutes ADC
                    # distance/approx membership and skips expansion for
                    # this row, so these zeros are never consumed
                    self.counters.degraded += 1
                    continue
            out["vectors"][i] = rec["vector"]
            out["neighbors"][i] = rec["neighbors"]
            out["dense_neighbors"][i] = rec["dense_neighbors"]
            out["rec_labels"][i] = rec["rec_labels"]
            out["rec_values"][i] = rec["rec_values"]
            out["cand_first"][i] = rec["cand_first"]
        if not track:
            return out
        self.counters.records_fetched += n_live
        batch_pages = self.counters.pages_read - pages_before
        if n_live > 1 and batch_pages > 0 and \
                len(self.samples) < _MAX_SAMPLES:
            self.samples.append({"pages": batch_pages,
                                 "us": (time.perf_counter() - t0) * 1e6,
                                 "kind": "batch"})
        if self.prefetch_depth >= 2:
            self._readahead(out["neighbors"], live, dense)
        return out

    def _readahead(self, neighbors: np.ndarray, live: np.ndarray,
                   dense: bool):
        """Real read-ahead driven by ``prefetch_depth``: warm the cache
        with the just-fetched records' nearest out-neighbors — the ids
        most likely to be the next frontier. Depth scales the per-record
        window; correctness is cache-transparent either way."""
        cfg = self.config
        per = cfg.readahead_per_record * (self.prefetch_depth - 1)
        if per <= 0:
            return
        budget = cfg.readahead_batch_cap
        for i in range(neighbors.shape[0]):
            if budget <= 0:
                break
            if not live[i]:
                continue
            taken = 0
            for nid in neighbors[i]:
                if taken >= per or budget <= 0:
                    break
                if nid < 0:
                    continue
                pids = [p for p in self._slab_page_ids(int(nid), dense)
                        if not self.cache.contains(p)]
                if not pids:
                    continue
                before = self.counters.pages_read
                self._get_pages(pids, readahead=True)
                got = self.counters.pages_read - before
                self.counters.readahead_pages += got
                budget -= got
                taken += 1

    # -- attribute probes (strict in-filtering) --------------------------
    def read_attrs(self, ids: np.ndarray, need: np.ndarray,
                   gate: np.ndarray) -> dict:
        """Bloom-gated attribute page reads.

        ``need`` marks rows the strict hop actually verifies; ``gate`` is
        the device-tier approximate membership computed *before* this
        call. A needed row whose gate is False skips its page read and
        returns poisoned attributes (labels −1, values NaN) — exact
        verification would reject it anyway (no-false-negative superset),
        so results are bit-identical while the page read is saved.
        """
        with trace.span("disk.read_attrs"):
            ids = np.asarray(ids, np.int64).reshape(-1)
            need = np.asarray(need, bool).reshape(-1)
            gate = np.asarray(gate, bool).reshape(-1)
            n = ids.size
            lo = self.layout
            labels = np.full((n, lo.max_labels), -1, np.int32)
            values = np.full((n, lo.n_fields), np.nan, np.float32)
            self.counters.attr_probes += int(need.sum())
            self.counters.gated_skips += int((need & ~gate).sum())
            for i in np.nonzero(need & gate)[0]:
                rid = int(ids[i])
                pid = rid * lo.slab_pages + lo.attr_page
                page = self._get_pages([pid])[pid]
                attrs = slab_mod.decode_attrs(lo, page)
                labels[i] = attrs["rec_labels"]
                values[i] = attrs["rec_values"]
                self.counters.attr_reads += 1
            return {"rec_labels": labels, "rec_values": values}

    # -- host-side readers (prefilter re-rank, ground truth) -------------
    def fetch_host(self, ids: np.ndarray) -> dict:
        """Plain std-block fetch for host-driven paths (no faults)."""
        return self.fetch(ids, hops=None, live=None, dense=False)

    def read_vectors(self, ids: np.ndarray, track: bool = False
                     ) -> np.ndarray:
        """The float32 vectors of ``ids`` (std blocks), untracked unless
        asked."""
        return self.fetch(ids, dense=False, track=track)["vectors"]

    def scan_records(self, start: int = 0, stop: int | None = None) -> dict:
        """Sequential full scan for evaluation paths (ground truth): reads
        std blocks straight off the file, bypassing cache and counters so
        an offline scan doesn't evict the serving working set."""
        stop = self.n if stop is None else min(stop, self.n)
        lo = self.layout
        m = max(0, stop - start)
        out = {"vectors": np.zeros((m, lo.dim), np.float32),
               "rec_labels": np.full((m, lo.max_labels), -1, np.int32),
               "rec_values": np.zeros((m, lo.n_fields), np.float32)}
        sb = lo.slab_bytes
        for i in range(m):
            blk = os.pread(self._fd, lo.std_bytes, (start + i) * sb)
            rec = slab_mod.decode_std(lo, blk)
            out["vectors"][i] = rec["vector"]
            out["rec_labels"][i] = rec["rec_labels"]
            out["rec_values"][i] = rec["rec_values"]
        return out

    # -- observability ---------------------------------------------------
    def snapshot(self) -> dict:
        c = self.counters.as_dict()
        c.update(self.cache.counters())
        tot = c["hits"] + c["misses"]
        c["hit_rate"] = c["hits"] / tot if tot else 0.0
        per_page = sorted(s["us"] / s["pages"] for s in self.samples
                          if s["kind"] == "serial")
        if per_page:
            c["p50_page_us"] = per_page[len(per_page) // 2]
            c["p95_page_us"] = per_page[min(len(per_page) - 1,
                                            int(len(per_page) * 0.95))]
        else:
            c["p50_page_us"] = c["p95_page_us"] = 0.0
        c["n_samples"] = len(self.samples)
        return c

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Counter delta between two snapshots (rates recomputed)."""
        keys = _Counters.FIELDS + ("hits", "misses", "evictions",
                                   "readahead_hits")
        d = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
        tot = d["hits"] + d["misses"]
        d["hit_rate"] = d["hits"] / tot if tot else 0.0
        return d

    def reset_counters(self):
        self.counters = _Counters()
        self.cache.hits = self.cache.misses = 0
        self.cache.evictions = self.cache.readahead_hits = 0
        self.samples = []


def _attempt_draws(ids: np.ndarray, hops: np.ndarray,
                   plan: FaultPlan) -> tuple[np.ndarray, np.ndarray]:
    """(attempts, n) bool draws — fail / corrupt — via the NumPy twin of
    the hop step's stateless hash, so the host read path and the hop
    step's counter/degrade logic see the same fault pattern."""
    fail = np.stack([faults_mod.read_fail_np(ids, hops, a, plan)
                     for a in range(plan.attempts)])
    corrupt = np.stack([faults_mod.read_corrupt_np(ids, hops, a, plan)
                        for a in range(plan.attempts)])
    return fail, corrupt

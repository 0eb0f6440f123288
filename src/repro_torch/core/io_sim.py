"""SSD I/O accounting for the device-resident record store (numpy copy of
``repro.core.io_sim``; the port keeps its own copy so it never imports the
JAX package).

The paper evaluates on SSD pages (4 KB). The same accounting unit is kept so
the paper's I/O-centric figures reproduce exactly, while the physical
transport on the GPU is a device-memory record gather.

All search routines thread integer page counters through their hop loops;
this module centralizes the constants and the latency model.
"""
from __future__ import annotations

import dataclasses
import math


PAGE_BYTES = 4096


@dataclasses.dataclass(frozen=True)
class IOModel:
    """Latency/throughput model applied to counted I/O.

    t_page_us: modeled latency of one random 4 KB read (NVMe incl. queueing).
    parallelism: in-flight reads the device sustains (SSD queue depth analogue;
        on the card this is the coalesced-gather width).
    """
    page_bytes: int = PAGE_BYTES
    t_page_us: float = 100.0
    parallelism: int = 64

    def pages(self, nbytes: int) -> int:
        return max(1, math.ceil(nbytes / self.page_bytes))

    def latency_us(self, pages_sequentially_dependent: int,
                   pages_parallel: int = 0, prefetch_depth: int = 1,
                   compute_us: float = 0.0) -> float:
        """Modeled I/O latency: dependent pages serialize (graph hops),
        batched pages overlap up to ``parallelism``.

        ``prefetch_depth`` is the search loop's in-flight record-slab
        count (``SearchParams.prefetch_depth``) and ``compute_us`` the
        total per-query compute on the hop critical path. With depth ≥ 2
        (the double-buffered loop) the next hop's dependent read is
        issued before the current hop's distance/membership pass runs, so
        compute hides behind I/O (and vice versa): the serial term is
        ``max(read, compute)`` per the paper's pipeline, instead of their
        sum. Beam reads within a hop (``pages_parallel``) overlap through
        device parallelism either way; the dependent *chain length* never
        shrinks — hop t+1's target still comes out of hop t's merge.
        """
        par = math.ceil(pages_parallel / max(1, self.parallelism))
        read_us = pages_sequentially_dependent * self.t_page_us
        if prefetch_depth >= 2:
            serial_us = max(read_us, compute_us)
        else:
            serial_us = read_us + compute_us
        return serial_us + par * self.t_page_us

    @classmethod
    def calibrate_from_samples(cls, samples, page_bytes: int = PAGE_BYTES,
                               parallelism_grid=(1, 2, 4, 8, 16, 32, 64,
                                                 128, 256)) -> "IOModel":
        """Fit ``t_page_us`` / ``parallelism`` from measured slab reads.

        ``samples`` is an iterable of dicts (``storage.DiskRecordStore``
        emits them): ``{"pages": int, "us": float, "kind": "serial" |
        "batch"}``. Serial samples are single dependent pread runs —
        ``t_page_us`` is the median measured per-page latency (median, so
        one OS-cache outlier or compaction stall doesn't skew the fit).
        Batch samples are multi-record fetches whose pages overlap up to
        the device's queue depth: ``parallelism`` is the grid value
        minimizing relative error of ``ceil(pages / p) * t_page_us``
        against the measured batch times. Falls back to the class
        defaults for whichever family has no samples.
        """
        serial = [s for s in samples if s["kind"] == "serial"
                  and s["pages"] > 0 and s["us"] > 0]
        batch = [s for s in samples if s["kind"] == "batch"
                 and s["pages"] > 0 and s["us"] > 0]
        if not serial:
            return cls(page_bytes=page_bytes)
        per_page = sorted(s["us"] / s["pages"] for s in serial)
        t_page = per_page[len(per_page) // 2]
        parallelism = cls.parallelism          # dataclass default
        if batch:
            best = None
            for p in parallelism_grid:
                err = sum(
                    abs(math.ceil(s["pages"] / p) * t_page - s["us"])
                    / s["us"] for s in batch) / len(batch)
                if best is None or err < best[0]:
                    best = (err, p)
            parallelism = best[1]
        return cls(page_bytes=page_bytes, t_page_us=t_page,
                   parallelism=parallelism)

    def faulted_latency_us(self, pages_sequentially_dependent: int,
                           plan, faults: int = 0, retries: int = 0,
                           spikes: int = 0, pages_parallel: int = 0,
                           prefetch_depth: int = 1,
                           compute_us: float = 0.0) -> float:
        """Modeled latency of the same work under a fault plan.

        ``retries``/``spikes`` are the *measured* counters from a faulted
        run (``SearchResult.retries``; spikes ride ``faults`` when not
        broken out). Each retry re-reads its pages after a capped
        exponential backoff (``plan.backoff_us`` doubling up to
        ``plan.backoff_cap_us``); a hedged attempt overlaps the original
        read, so it costs no extra serial time beyond its page read; a
        spiked read stretches to ``plan.spike_factor`` × t_page_us. All
        accounting-only — results never depend on modeled time.
        """
        base = self.latency_us(pages_sequentially_dependent, pages_parallel,
                               prefetch_depth, compute_us)
        if plan is None or retries + spikes + faults == 0:
            return base
        backoff = 0.0
        b = plan.backoff_us
        # attribute the mean backoff ladder position to each retry
        for _ in range(max(1, plan.max_retries)):
            backoff += min(b, plan.backoff_cap_us)
            b *= 2.0
        backoff /= max(1, plan.max_retries)
        retry_us = retries * (self.t_page_us + backoff)
        spike_us = spikes * (plan.spike_factor - 1.0) * self.t_page_us
        return base + retry_us + spike_us


def record_bytes(dim: int, vec_dtype_size: int, n_neighbors: int,
                 max_labels: int, n_numeric: int) -> int:
    """Size of one co-located record: full vector + neighbor IDs + attributes.

    Mirrors the paper's layout: the attributes ride in the record's final-page
    slack, so verification costs no extra I/O beyond the re-rank fetch.
    """
    vec = dim * vec_dtype_size
    nbrs = 4 + n_neighbors * 4          # count + ids
    attrs = 4 + max_labels * 4 + n_numeric * 4
    return vec + nbrs + attrs


def record_pages(dim: int, vec_dtype_size: int, n_neighbors: int,
                 max_labels: int, n_numeric: int,
                 page_bytes: int = PAGE_BYTES) -> int:
    return max(1, math.ceil(
        record_bytes(dim, vec_dtype_size, n_neighbors, max_labels, n_numeric)
        / page_bytes))

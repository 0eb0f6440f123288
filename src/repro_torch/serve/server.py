"""Resilient serving tier: deadline-aware admission, backpressure,
graceful load degradation, and overload shedding over the batched engine.

The ``Session`` batches requests; ``SearchServer`` turns that into a
*service*: flushes run on a dedicated worker thread (callers never block
on device work they didn't ask for), admission is deadline- and
SLO-aware, and overload walks the load-degrade ladder before anything is
dropped — the load-fault analogue of the I/O fault ladder.

Admission pipeline (``submit``):

1. **Backpressure** — the queue is bounded (``max_queue``); a full queue
   rejects with :class:`~repro_torch.api.types.Overloaded`, carrying a
   ``retry_after_s`` hint equal to the predicted backlog drain time.
2. **Deadline feasibility** — a request with ``deadline_us`` is priced by
   the cost model (``engine.estimate_cost`` per the compiled
   filter's plan) and its completion predicted as queue-wait + service
   under an *affine* service model fitted on measured flushes:
   ``wall ≈ overhead_us + us_per_cost × batch_cost``. The fixed per-flush
   overhead term matters — dispatch dominates small flushes, so a single
   µs-per-cost ratio learned from small batches overprices large ones
   (and vice versa), which under-batches the worker at low load. If even
   the cheapest ladder rung cannot make the deadline, the request is
   shed at admission with :class:`~repro_torch.api.types.DeadlineExceeded`.
3. **Enqueue** — otherwise the request joins the queue and its handle is
   returned immediately (``PendingSearch.result(timeout=...)`` waits).

The worker cuts batches on the p99 *budget*, not just size: entries are
taken while the predicted batch service time fits both ``slo_p99_us``
and the tightest queued deadline's headroom. Queue pressure (and
deadline infeasibility at the current rung) selects the degrade rung —
``cost_model.DEGRADE_LADDER``: full → lean (drop read-ahead, results
invariant) → reduced/minimal (scaled L and hop budget, still exactly
verified) → scan (gated full-corpus ADC + exact verify; approximate
candidate generation, never a false negative). Expired entries are shed
(their handles fail with ``DeadlineExceeded``); everything admitted to a
batch resolves through the session's poisoned-batch isolation.

Counterpart of ``repro.serve.server``. The worker thread launches the
card's kernels on its own current stream (the default stream, as the
caller's), and every result crosses to the host inside the engine call, so
a handle resolves only after the card finished its batch.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.api.session import PendingSearch, Session, SessionConfig
from repro_torch.api.types import (DeadlineExceeded, Overloaded,
                                   SearchRequest, ServeError)
from repro_torch.core import cost_model
from repro_torch.core.engine import apply_rung, scan_rerank


def _now_us() -> float:
    return time.monotonic() * 1e6


def _is_degraded(rung: cost_model.DegradeRung) -> bool:
    """True when the rung alters service at all (any config delta or the
    approximate path) — ladder *position* is irrelevant, so custom
    ladders count correctly."""
    return (rung.approx or rung.l_scale != 1.0
            or rung.max_hops_scale != 1.0
            or rung.hop_chunk is not None
            or rung.prefetch_depth is not None)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_queue: int = 256         # bounded admission queue (backpressure)
    max_batch: int = 32          # batch-size cut (upper bound)
    max_delay_s: float = 0.002   # batching window for a non-full batch
    slo_p99_us: float = 500_000.0
    # p99 service budget: the worker stops growing a batch when its
    # predicted service time would exceed this (or a queued deadline)
    degrade_at: tuple = (0.25, 0.45, 0.65, 0.85)
    # queue-fill fractions stepping the degrade rung: below the first
    # the server runs full service, past the last it serves rung 4
    seed_us_per_cost: float = 1.0
    # µs per cost-model unit before the first measured flush
    fit_window: int = 64         # (batch_cost, wall) pairs the affine
                                 # service model is refitted over
    tail_quantile: float = 0.9   # quantile of observed (actual − predicted)
    # flush-wall error added to deadline-facing predictions: the mean
    # model admits requests that a p90-slow flush pushes past their
    # deadline, so SLO comparisons carry an additive tail guard. The
    # guard is additive, not multiplicative — flush jitter here is
    # dispatch noise that doesn't scale with batch cost, and a ratio
    # learned on small overhead-dominated flushes would overpenalize
    # large predictions and over-shed at moderate load
    window: int = 512            # rolling completion-latency window
    isolate_failures: bool = True
    flush_retry_budget: int = 8


@dataclasses.dataclass
class ServerStats:
    """Health/readiness probe snapshot (all counters cumulative)."""
    queue_depth: int
    in_flight: int
    degrade_rung: int            # ladder index the last batch ran at
    rung_name: str
    p50_us: float                # rolling completion latency (admitted)
    p99_us: float
    admitted: int
    completed: int
    rejected_overload: int       # backpressured at admission
    shed_deadline: int           # shed at admission or expired in queue
    deadline_misses: int         # completed, but past their deadline
    degraded_served: int         # completed at any service-altering rung
    us_per_cost: float           # fitted marginal cost→µs scale (slope)
    overhead_us: float           # fitted fixed per-flush wall (intercept)
    tail_guard_us: float         # p-tail prediction-error margin added
                                 # to deadline-facing predictions
    healthy: bool                # worker thread alive
    ready: bool                  # healthy ∧ accepting (not stopping)
    warmed: bool                 # warmup() has run
    shards: int = 1              # shards the hop loop spans
                                 # (engine.n_shards; 1 = unsharded)
    # what the queue costs: completed ÷ flushes is the mean batch an
    # operator tunes max_batch/max_delay_s against, and queue_wait_us ÷
    # completed the mean wait before a request's flush starts, which
    # tells queueing from service when p99_us rises
    flushes: int = 0             # batches the worker executed
    queue_wait_us: float = 0.0   # Σ over their requests of flush start −
                                 # admission


@dataclasses.dataclass
class _Entry:
    handle: PendingSearch
    admit_us: float
    deadline_abs_us: Optional[float]     # absolute µs (monotonic clock)
    ci: cost_model.CostInputs
    scfg: object                         # resolved base SearchConfig
    cost_full: float                     # rung-0 modeled cost
    cost_cheapest: Optional[float] = None   # min over the ladder (only
    # priced for deadline-carrying requests; drives predictive shedding)


class SearchServer:
    """Threaded serving frontend over an
    :class:`~repro_torch.api.index.Index`. A sharded index
    (``Index.build(shards=)``, ``Index.load(shards=)``) serves through the
    same path: each flush's groups run their hop loop through the engine's
    sharded runner. ``stats().shards`` reports ``engine.n_shards``."""

    def __init__(self, index, config: ServerConfig = ServerConfig(),
                 ladder: tuple = cost_model.DEGRADE_LADDER):
        self.index = index
        self.config = config
        self.ladder = ladder
        self.session = Session(index, SessionConfig(
            auto_flush=False,
            isolate_failures=config.isolate_failures,
            flush_retry_budget=config.flush_retry_budget))
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._queued_cost = 0.0
        self._inflight_cost = 0.0
        self._in_flight = 0
        self._rung_idx = 0
        self._us_per_cost = float(config.seed_us_per_cost)
        self._overhead_us = 0.0
        self._obs: collections.deque = collections.deque(
            maxlen=config.fit_window)
        self._err: collections.deque = collections.deque(
            maxlen=config.fit_window)
        self._tail_guard_us = 0.0   # grows as prediction errors accumulate
        self._lat_window: collections.deque = collections.deque(
            maxlen=config.window)
        self._admitted = 0
        self._completed = 0
        self._rejected = 0
        self._shed = 0
        self._misses = 0
        self._degraded = 0
        self._flushes = 0
        self._queue_wait_us = 0.0
        self._warmed = False
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="search-server-worker")
        self._worker.start()

    # -- lifecycle -------------------------------------------------------
    def warmup(self, requests: Sequence[SearchRequest], **kw) -> None:
        """Run the bucket ladder and the degrade-rung config variants
        (``Session.warmup``) so first-use costs (the kernels' build, the
        allocator's first blocks) don't masquerade as deadline misses."""
        self.session.warmup(requests, **kw)
        with self._lock:
            self._warmed = True

    def calibrate_service_model(self, requests: Sequence[SearchRequest]):
        """Seed the affine service model with two measured flushes — a
        single query and a full batch — run directly through the engine
        (bypassing admission). Two observations at well-separated batch
        costs pin both terms, so the very first admitted request is
        priced by measurement instead of ``seed_us_per_cost``; without
        this, a cold server under-batches (and over-sheds) until enough
        live flushes accumulate to fit the model. Returns the fitted
        ``(overhead_us, us_per_cost)``."""
        reqs = list(requests)[: max(2, self.config.max_batch)]
        if len(reqs) < 2:
            raise ValueError("need at least 2 requests to calibrate")
        costs = [self._price(r)[1] for r in reqs]
        self.index.search_batch(reqs, with_metadata=False)      # warm
        pairs = []
        for sub in (reqs[:1], reqs):
            t0 = _now_us()
            self.index.search_batch(sub, with_metadata=False)
            pairs.append((float(sum(costs[: len(sub)])), _now_us() - t0))
        with self._lock:
            for p in pairs:
                self._refit_locked(*p)
            return self._overhead_us, self._us_per_cost

    def stop(self, timeout: float = 30.0) -> None:
        """Stop accepting, drain the queue, join the worker."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._worker.join(timeout)

    close = stop

    def __enter__(self) -> "SearchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission -------------------------------------------------------
    def _price(self, request: SearchRequest):
        sel = self.index.compile_filter(request.filter)
        scfg = self.index._resolve_scfg(request)
        eng = self.index.engine
        cfg = eng.config
        plan = sel.plan(cfg.ql, cfg.cap, cfg.qr)
        ci = eng.cost_inputs(plan, scfg)
        route = eng._route(plan, scfg)
        full = route.costs[route.mechanism].total(scfg.alpha, scfg.beta)
        return ci, full, scfg

    def _rung_cost(self, e: _Entry, rung: cost_model.DegradeRung) -> float:
        sc = e.scfg
        return cost_model.rung_cost(
            e.ci, rung, sc.alpha, sc.beta, sc.max_pool,
            base_prefetch=sc.prefetch_depth,
            rerank=scan_rerank(sc, rung),
            calib=self.index.engine.calibration)

    def _predict_us(self, cost: float, flushes: int = 1) -> float:
        """Predicted wall µs to serve ``cost`` model units spread over
        ``flushes`` flushes: fixed per-flush overhead + marginal cost.
        The two-term shape is what keeps the scheduler sane at both ends
        of the load curve — cutting a batch smaller does *not* make its
        flush finish much sooner."""
        return flushes * self._overhead_us + cost * self._us_per_cost

    def _predict_tail_us(self, cost: float, flushes: int = 1) -> float:
        """Tail-guarded prediction for deadline/SLO comparisons: the
        mean model is right on average but a p90-slow flush pushes a
        just-fits request past its deadline, so anything compared against
        a deadline carries the observed tail error margin on top."""
        return self._predict_us(cost, flushes) + self._tail_guard_us

    def _backlog_us_locked(self) -> float:
        flushes = (1 if self._in_flight else 0) + int(
            -(-len(self._queue) // max(1, self.config.max_batch)))
        return self._predict_us(
            self._queued_cost + self._inflight_cost, flushes)

    def _refit_locked(self, batch_cost: float, wall_us: float) -> None:
        """Refit the affine service model on the observation window.
        With degenerate cost spread (every batch the same size) the
        slope/intercept split is unidentifiable, so fall back to the
        amortized ratio with zero overhead — conservative, and correct
        at exactly the operating point being observed."""
        pred = self._predict_us(batch_cost)
        if len(self._obs) >= 2 and pred > 0.0:
            # error vs the model that actually priced this flush (the
            # pre-refit fit); skipped while only the config seed is live
            self._err.append(wall_us - pred)
            if len(self._err) >= 4:
                self._tail_guard_us = max(0.0, float(np.quantile(
                    np.fromiter(self._err, np.float64),
                    self.config.tail_quantile)))
        self._obs.append((batch_cost, wall_us))
        x = np.fromiter((o[0] for o in self._obs), np.float64)
        y = np.fromiter((o[1] for o in self._obs), np.float64)
        slope = None
        if x.size >= 2 and float(np.ptp(x)) > 0.05 * float(x.mean()):
            slope, intercept = np.polyfit(x, y, 1)
        if slope is None or slope <= 0.0:
            self._us_per_cost = float(y.sum() / max(float(x.sum()), 1e-9))
            self._overhead_us = 0.0
        else:
            self._us_per_cost = float(slope)
            self._overhead_us = float(max(0.0, intercept))

    def submit(self, request: SearchRequest) -> PendingSearch:
        """Admit one request; returns its handle or raises
        ``Overloaded`` / ``DeadlineExceeded`` (shed at admission)."""
        ci, full, scfg = self._price(request)       # host-side, lock-free
        handle = PendingSearch(self.session, request)
        # the server owns scheduling: mark the handle claimed so
        # result() waits on the worker instead of forcing a session flush
        handle._claimed = True
        handle.rung = None
        now = _now_us()
        with self._work:
            if self._stop:
                raise ServeError("server is stopped")
            if len(self._queue) >= self.config.max_queue:
                self._rejected += 1
                raise Overloaded(
                    f"admission queue full "
                    f"({len(self._queue)}/{self.config.max_queue})",
                    retry_after_s=self._backlog_us_locked() / 1e6)
            entry = _Entry(handle, now, None, ci, scfg, full)
            if request.deadline_us is not None:
                entry.deadline_abs_us = now + float(request.deadline_us)
                entry.cost_cheapest = min(self._rung_cost(entry, r)
                                          for r in self.ladder)
                predicted = self._backlog_us_locked() \
                    + self._predict_tail_us(entry.cost_cheapest)
                if predicted > float(request.deadline_us):
                    self._shed += 1
                    raise DeadlineExceeded(
                        f"predicted completion {predicted:.0f}µs exceeds "
                        f"deadline {request.deadline_us:.0f}µs even at "
                        f"the cheapest degrade rung")
            self._queue.append(entry)
            self._queued_cost += full
            self._admitted += 1
            self._work.notify()
        return handle

    def submit_many(self, requests: Sequence[SearchRequest]) -> list:
        return [self.submit(r) for r in requests]

    # -- scheduling ------------------------------------------------------
    def _pick_rung_locked(self, now: float) -> int:
        """Queue pressure *permits* rungs 0..i (``degrade_at``
        thresholds); the batch executes at the cheapest permitted rung
        for the head-of-queue request, so the effective service cost is
        monotone non-increasing in pressure even where a raw rung cost
        inverts. A queued deadline that cannot hold at that choice
        escalates the permission (degradation before shedding)."""
        pressure = len(self._queue) / max(1, self.config.max_queue)
        permit = min(sum(pressure >= f for f in self.config.degrade_at),
                     len(self.ladder) - 1)
        head = self._queue[0]
        tight = None              # (headroom_us, entry) of tightest deadline
        for e in self._queue:
            if e.deadline_abs_us is not None:
                room = e.deadline_abs_us - now
                if tight is None or room < tight[0]:
                    tight = (room, e)

        def pick(limit: int) -> int:
            costs = [self._rung_cost(head, self.ladder[j])
                     for j in range(limit + 1)]
            return min(range(limit + 1), key=costs.__getitem__)

        idx = pick(permit)
        while tight is not None and permit < len(self.ladder) - 1:
            c = self._rung_cost(tight[1], self.ladder[idx])
            if self._predict_tail_us(c) <= tight[0]:
                break
            permit += 1
            idx = pick(permit)
        return idx

    def _cut_batch_locked(self, now: float):
        """Pop a batch: expired or provably-late entries shed, the rest
        taken while the predicted batch service time fits the
        p99/deadline budget. Shedding a doomed entry instead of letting
        it through matters twice over — it would waste service, and its
        collapsed headroom would strangle the batch budget for healthy
        batchmates."""
        rung_idx = self._pick_rung_locked(now)
        rung = self.ladder[rung_idx]
        batch: list = []
        batch_cost = 0.0
        budget = self.config.slo_p99_us
        shed: list = []
        while self._queue and len(batch) < self.config.max_batch:
            e = self._queue[0]
            c = self._rung_cost(e, rung)
            if e.deadline_abs_us is not None:
                room = e.deadline_abs_us - now
                # doomed: expired, or misses even riding this batch at
                # its ladder-cheapest cost (FIFO — waiting only worsens)
                late = self._predict_tail_us(
                    batch_cost + min(c, e.cost_cheapest))
                if room <= 0 or late > room:
                    self._queue.popleft()
                    self._queued_cost -= e.cost_full
                    shed.append(e)
                    continue
                head = min(budget, room)
            else:
                head = budget
            if batch and self._predict_tail_us(batch_cost + c) > head:
                break          # p99-budget cut, not size
            budget = head
            self._queue.popleft()
            self._queued_cost -= e.cost_full
            batch.append(e)
            batch_cost += c
        self._rung_idx = rung_idx
        self._in_flight = len(batch)
        self._inflight_cost = batch_cost
        return batch, batch_cost, rung_idx, shed

    def _run(self) -> None:
        cfg = self.config
        while True:
            with self._work:
                while not self._stop and not self._queue:
                    self._work.wait(0.1)
                if not self._queue:
                    if self._stop:
                        return
                    continue
                # batching window: give the batch a chance to fill
                while (not self._stop
                       and len(self._queue) < cfg.max_batch):
                    age_s = (_now_us() - self._queue[0].admit_us) / 1e6
                    if age_s >= cfg.max_delay_s:
                        break
                    self._work.wait(cfg.max_delay_s - age_s)
                batch, batch_cost, rung_idx, shed = \
                    self._cut_batch_locked(_now_us())
            for e in shed:
                e.handle._fail(DeadlineExceeded(
                    "deadline expired while queued"))
            with self._lock:
                self._shed += len(shed)
            if not batch:
                continue
            self._execute(batch, batch_cost, rung_idx)

    def _execute(self, batch: list, batch_cost: float,
                 rung_idx: int) -> None:
        cfg = self.config
        rung = self.ladder[rung_idx]
        scfgs = [apply_rung(self.index._resolve_scfg(e.handle.request),
                            rung) for e in batch]
        if rung.approx:
            def executor(reqs, cfgs):
                return self.index.approx_scan_batch(reqs, scfgs=cfgs)
        else:
            def executor(reqs, cfgs):
                return self.index.search_batch(reqs, scfgs=cfgs)
        # stamp the rung before execution: a result() waiter wakes the
        # instant its handle resolves and must see which rung served it
        for e in batch:
            e.handle.rung = rung.name
        t0 = _now_us()
        budget = [max(1, cfg.flush_retry_budget)]
        try:
            self.session._execute_isolated(
                [e.handle for e in batch], budget, scfgs, executor)
        finally:
            for e in batch:
                if not e.handle._done:
                    e.handle._fail(RuntimeError(
                        "serve batch aborted before resolving this "
                        "handle"))
        done = _now_us()
        with self._lock:
            self._flushes += 1
            self._queue_wait_us += sum(t0 - e.admit_us for e in batch)
            self._refit_locked(batch_cost, done - t0)
            degraded = _is_degraded(rung)
            for e in batch:
                self._lat_window.append(done - e.admit_us)
                self._completed += 1
                if degraded:
                    self._degraded += 1
                if (e.deadline_abs_us is not None
                        and done > e.deadline_abs_us):
                    self._misses += 1
            self._in_flight = 0
            self._inflight_cost = 0.0

    # -- observability ---------------------------------------------------
    def stats(self) -> ServerStats:
        with self._lock:
            lat = np.asarray(self._lat_window, np.float64)
            alive = self._worker.is_alive()
            return ServerStats(
                queue_depth=len(self._queue),
                in_flight=self._in_flight,
                degrade_rung=self._rung_idx,
                rung_name=self.ladder[self._rung_idx].name,
                p50_us=float(np.percentile(lat, 50)) if lat.size else 0.0,
                p99_us=float(np.percentile(lat, 99)) if lat.size else 0.0,
                admitted=self._admitted,
                completed=self._completed,
                rejected_overload=self._rejected,
                shed_deadline=self._shed,
                deadline_misses=self._misses,
                degraded_served=self._degraded,
                us_per_cost=self._us_per_cost,
                overhead_us=self._overhead_us,
                tail_guard_us=self._tail_guard_us,
                healthy=alive,
                ready=alive and not self._stop,
                warmed=self._warmed,
                shards=self.index.engine.n_shards,
                flushes=self._flushes,
                queue_wait_us=self._queue_wait_us)

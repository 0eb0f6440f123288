"""``Session`` — incremental request admission with batched execution.

The engine's request path groups a batch by (mechanism, pool bucket,
config) and runs each group as one coalesced device call; a Session
generalizes that batching *across callers*: requests are admitted one at
a time (e.g. by a serving frontend), accumulate in a pending queue, and
flush together when the batch fills, the oldest request exceeds the
flush deadline, or a result is demanded.

Thread-safe since the serving tier (serve/server.py) landed: submits,
flushes, and ``result()`` waits may race from any number of threads. The
pending queue swaps under a lock, handles resolve through per-handle
events, and executions serialize on a separate lock so concurrent
flushes never interleave device work. Deadlines are still checked at
admission and at ``poll()`` — the single-threaded serve-loop tick stays
deterministic; the threaded server owns its *own* scheduling on top.

Counterpart of ``repro.api.session``. Executions serialize on one lock, so
the card sees one caller's launches at a time, whichever thread flushes.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional, Sequence

from repro_torch.api.types import SearchRequest, SearchResult


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    max_batch: int = 32          # flush when this many requests are pending
    max_delay_s: float = 0.01    # flush when the oldest pending is this old
    auto_flush: bool = True      # admission/poll may trigger flushes
    isolate_failures: bool = True
    # a failed flush bisects the batch so only the offending request's
    # handle fails (poisoned-batch isolation); False restores the legacy
    # all-handles-fail contract
    flush_retry_budget: int = 8
    # max execution attempts one flush may spend isolating bad requests
    # before the unexecuted remainder is failed wholesale


class PendingSearch:
    """Handle for a submitted request; resolves at flush time.

    Safe to wait on from any thread: resolution signals an event, so
    ``result(timeout=...)`` blocks only until the flush that *claimed*
    this handle (possibly on another thread) finishes with it.
    """

    def __init__(self, session: "Session", request: SearchRequest):
        self._session = session
        self.request = request
        self._result: Optional[SearchResult] = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._claimed = False        # a flush owns this handle's batch
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._done

    def _resolve(self, result: SearchResult):
        self._result = result
        self._done = True
        self._event.set()

    def _fail(self, error: BaseException):
        self._error = error
        self._done = True
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> SearchResult:
        """The SearchResult; forces a flush if still pending. Re-raises
        the batch's execution error if its flush failed.

        ``timeout`` (seconds) bounds the wait when *another* thread's
        flush holds this handle's batch — raises ``TimeoutError`` on
        expiry with the handle still in flight (a later call may
        succeed)."""
        if not self._done:
            try:
                self._session.flush()
            except Exception:
                # if the flush failed *this* handle, its _fail below
                # carries the cause; swallow the duplicate here
                if not self._done:
                    raise
        if not self._done:
            if not self._claimed:
                # a flush ran but never touched this handle (e.g.
                # submitted to a different session than the one flushed)
                # — surface a real error instead of tripping a bare assert
                raise RuntimeError(
                    "PendingSearch never resolved: flush() completed "
                    "without executing this handle's request")
            # another thread's flush owns the batch: wait for it
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"PendingSearch.result timed out after {timeout}s "
                    "with the request still in flight")
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(
                "PendingSearch never resolved: flush() completed without "
                "executing this handle's request")
        return self._result


class Session:
    """Batched scheduler over an :class:`~repro_torch.api.index.Index`."""

    def __init__(self, index, config: SessionConfig = SessionConfig()):
        self.index = index
        self.config = config
        self._pending: list = []          # (PendingSearch, t_admitted)
        self._lock = threading.Lock()     # guards _pending + counters
        self._exec_lock = threading.Lock()  # serializes engine execution
        self.n_requests = 0
        self.n_batches = 0
        self.n_flushed = 0

    # -- admission -------------------------------------------------------
    def submit(self, request: SearchRequest) -> PendingSearch:
        handle = PendingSearch(self, request)
        with self._lock:
            self._pending.append((handle, time.monotonic()))
            self.n_requests += 1
            should = self.config.auto_flush and self._should_flush()
        if should:
            self.flush()
        return handle

    def submit_many(self, requests: Sequence[SearchRequest]) -> list:
        return [self.submit(r) for r in requests]

    def warmup(self, requests: Sequence[SearchRequest],
               ladder: bool = True,
               rungs: Optional[Sequence] = None) -> None:
        """Run the serving mix through every path a flush can take before
        traffic arrives.

        ``repro`` fills its jit caches here; the port has none, but the
        first call still pays one-time costs (the CUDA kernels' build and
        load, the caching allocator's first blocks), and the contract is
        the same calls at the same rungs. One pass at the given mix, then
        with ``ladder`` (the default) each group — formed exactly as the
        engine will form it — tiled to every power-of-two width from
        ``MIN_COMPACT_BUCKET`` up to the group's rounded-up size, and every
        sub-minimum width once.

        ``rungs`` runs the serve tier's degrade-ladder config variants
        (default: every non-base rung of ``cost_model.DEGRADE_LADDER``,
        including the approximate-scan path through
        ``Index.approx_scan_batch``). Every non-approx rung gets the same
        per-group width tiling as the base configs. Pass ``()`` to skip.
        Results are discarded; counters untouched."""
        requests = list(requests)
        if not requests:
            return
        from repro_torch.core import cost_model, search as search_mod
        from repro_torch.core.engine import apply_rung

        idx = self.index
        idx.search_batch(requests, with_metadata=False)
        scfgs = [idx._resolve_scfg(r) for r in requests]
        eng = idx.engine
        cfg = eng.config
        mb = search_mod.MIN_COMPACT_BUCKET

        def ladder_pass(cfgs) -> None:
            """Group exactly as the engine will under ``cfgs`` and run
            each group at every power-of-two width the padded driver
            can form (``mb`` .. next_pow2(group size))."""
            groups: dict = {}
            for i, r in enumerate(requests):
                sel = idx.compile_filter(r.filter)
                plan = sel.plan(cfg.ql, cfg.cap, cfg.qr)
                route = eng._route(plan, cfgs[i])
                eff = 1 << max(5, math.ceil(
                    math.log2(max(route.effective_l, 1))))
                eff = min(eff, cfgs[i].max_pool)
                groups.setdefault((route.mechanism, eff, cfgs[i]),
                                  []).append(i)
            for members in groups.values():
                n = len(members)
                w = mb
                top = max(w, search_mod._pow2_at_least(n))
                while w <= top:
                    tiled = [members[j % n] for j in range(w)]
                    idx.search_batch([requests[j] for j in tiled],
                                     scfgs=[cfgs[j] for j in tiled],
                                     with_metadata=False)
                    w *= 2

        if ladder:
            ladder_pass(scfgs)
            # sub-min widths pad up to ``mb`` inside the driver: run
            # each once, against any mix
            for w in range(1, mb):
                idx.search_batch(requests[: min(w, len(requests))],
                                 with_metadata=False)
        if rungs is None:
            rungs = cost_model.DEGRADE_LADDER[1:]
        for rung in rungs:
            rcfgs = [apply_rung(sc, rung) for sc in scfgs]
            if rung.approx:
                idx.approx_scan_batch(requests, scfgs=rcfgs,
                                      with_metadata=False)
            elif ladder:
                ladder_pass(rcfgs)
            else:
                idx.search_batch(requests, scfgs=rcfgs,
                                 with_metadata=False)

    def _should_flush(self) -> bool:
        if len(self._pending) >= self.config.max_batch:
            return True
        if self._pending and (time.monotonic() - self._pending[0][1]
                              >= self.config.max_delay_s):
            return True
        return False

    def poll(self) -> int:
        """Serve-loop tick: flush if the deadline expired. Returns the
        number of requests executed."""
        with self._lock:
            should = self.config.auto_flush and self._should_flush()
        if should:
            return self.flush()
        return 0

    # -- execution -------------------------------------------------------
    def flush(self) -> int:
        """Execute every pending request as one grouped batch.

        With ``isolate_failures`` (the default) an execution error (e.g.
        a malformed filter in the batch) triggers poisoned-batch
        isolation: the batch is bisected and re-executed so only the
        offending request's handle fails — every well-formed request in
        the same flush still resolves, and the flush itself returns
        normally. Re-execution is bounded by ``flush_retry_budget``
        failing attempts; past it the not-yet-isolated remainder fails
        wholesale (no request is ever silently lost either way).

        With ``isolate_failures=False`` the legacy contract holds: every
        handle in the batch fails with the execution error and the error
        propagates to the flush caller.

        Concurrent flushes are safe: each atomically claims the pending
        batch under the lock (late flushes see an empty queue and return
        0), and every claimed handle either resolves or fails — a waiter
        on another thread is always woken."""
        with self._lock:
            if not self._pending:
                return 0
            batch, self._pending = self._pending, []
            for h, _ in batch:
                h._claimed = True
        handles = [h for h, _ in batch]
        try:
            if self.config.isolate_failures:
                budget = [max(1, self.config.flush_retry_budget)]
                self._execute_isolated(handles, budget)
            else:
                requests = [h.request for h in handles]
                try:
                    with self._exec_lock:
                        results = self.index.search_batch(requests)
                except Exception as e:
                    for handle in handles:
                        handle._fail(e)
                    raise
                for handle, result in zip(handles, results):
                    handle._resolve(result)
        finally:
            # no handle may be left claimed-but-unresolved (a waiter
            # would hang): fail any straggler from an unexpected escape
            for h in handles:
                if not h._done:
                    h._fail(RuntimeError(
                        "flush aborted before resolving this handle"))
        with self._lock:
            self.n_batches += 1
            self.n_flushed += len(batch)
        return len(batch)

    def _execute_isolated(self, handles: list, budget: list,
                          scfgs: Optional[list] = None,
                          executor=None) -> None:
        """Execute ``handles`` as one batch, bisecting on failure.

        ``budget`` is the flush's shared mutable count of *failing*
        attempts still allowed: a clean sub-batch costs nothing, so one
        poisoned request in a batch of ``n`` is isolated in
        ``log2(n) + 1`` failures.

        ``scfgs`` (optional, aligned with ``handles``) carries explicit
        per-request configs through the bisection — the serve tier's
        degrade rungs; ``executor`` overrides the execution callable
        (signature ``(requests, scfgs) -> results``, default the index's
        grouped ``search_batch``)."""
        if not handles:
            return
        if executor is None:
            def executor(reqs, cfgs):
                return self.index.search_batch(reqs, scfgs=cfgs)
        try:
            with self._exec_lock:
                results = executor([h.request for h in handles], scfgs)
        except Exception as e:
            budget[0] -= 1
            if len(handles) == 1:
                handles[0]._fail(e)
                return
            if budget[0] <= 0:
                err = RuntimeError(
                    "flush retry budget exhausted isolating a poisoned "
                    f"batch of {len(handles)} requests")
                err.__cause__ = e
                for h in handles:
                    h._fail(err)
                return
            mid = len(handles) // 2
            self._execute_isolated(handles[:mid], budget,
                                   scfgs[:mid] if scfgs else None,
                                   executor)
            self._execute_isolated(handles[mid:], budget,
                                   scfgs[mid:] if scfgs else None,
                                   executor)
            return
        for h, r in zip(handles, results):
            h._resolve(r)

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- observability ---------------------------------------------------
    def disk_stats(self) -> Optional[dict]:
        """Cumulative disk-tier snapshot (page cache hit/miss/readahead
        counters, measured page latency) when the index serves from the
        disk backend; None on the device backend."""
        ds = getattr(self.index.engine, "disk_store", None)
        return None if ds is None else ds.snapshot()

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()

"""Host data pipeline: bounded prefetch queue + straggler watchdog.

The producer thread stays `prefetch` batches ahead of the training loop;
``skip_to`` implements resume-exact restart (batches are pure functions of
the step index — see data/tokens.py). The watchdog flags steps slower than
`watchdog_factor`× the running median — on a real cluster this feeds the
straggler-mitigation policy (re-dispatch / hot-spare); here it logs.

Counterpart of ``repro.data.pipeline`` (plain Python, no tensors).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2):
        self.make_batch = make_batch
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.make_batch(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        while True:
            s, batch = self.q.get()
            yield s, batch

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


class StepWatchdog:
    """Detects straggling steps (slow I/O, slow device, bad host)."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: list = []
        self.flagged: list = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        slow = False
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.factor * med
            if slow:
                self.flagged.append((step, dt, med))
        self.times.append(dt)
        return slow

"""Host spans and per-batch counters of the served path.

:class:`span` times a region of host code. It always adds its *self* time
(its seconds minus those of the spans it holds) to the current batch's
tally, by name. While a ``torch.profiler`` records, it also opens
``torch.profiler.record_function("repro." + name)``, so the span lies on
the profiler's timeline beside the kernels and copies it launched. With no
profiler it calls no torch operator.

:func:`batch` opens a tally for one engine call on the calling thread (the
server flushes on its own worker): exact counters (``groups``,
``hop_steps``, ``row_hops_live``, ``row_hops_dispatched``, ``explored``
and ``fp_explored`` (the records the ``in`` and ``post`` rows explored, and
those of them that exact verification found invalid: the false positives
of the approximate membership test), and of the hop loop's CUDA graphs
``hop_steps_graphed``, the hop steps run by replay, and
``graph_captures``), the self seconds of each span name (``host_s``) and
the seconds the host blocked on the device (``device_wait_s``).
:func:`to_host` and :func:`sync` are the served path's blocking readbacks,
timed into ``device_wait_s``. Outside a batch, spans and counters record
nothing.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "repro."
COUNTERS = ("groups", "hop_steps", "row_hops_live", "row_hops_dispatched",
            "explored", "fp_explored", "hop_steps_graphed", "graph_captures")


class _Local(threading.local):
    top = None                 # innermost open span
    tally = None               # the open batch's tally


_local = _Local()


def new_tally() -> dict:
    """An empty tally: zero counters, no span seconds, no device wait."""
    t = dict.fromkeys(COUNTERS, 0)
    t["host_s"] = {}
    t["device_wait_s"] = 0.0
    return t


@contextlib.contextmanager
def batch():
    """Open a tally on this thread for the ``with`` block and yield it; the
    spans of the block add their seconds to it as they close. A batch
    opened inside another hides the outer one until it closes."""
    outer = _local.tally
    _local.tally = tally = new_tally()
    try:
        yield tally
    finally:
        _local.tally = outer


def count(**deltas) -> None:
    """Add to the open batch's counters (``device_wait_s`` included)."""
    tally = _local.tally
    if tally is not None:
        for k, v in deltas.items():
            tally[k] += v


class span:
    """``with span(name, **args):`` — see the module docstring. ``args``
    go to the profiler's event only; ``dt`` holds the span's seconds once
    it has closed."""
    __slots__ = ("name", "args", "parent", "child", "t0", "rf", "dt")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args

    def __enter__(self) -> "span":
        self.parent = _local.top
        _local.top = self
        self.child = 0.0
        self.rf = None
        # set while any torch.profiler records, whichever thread started it
        # (torch.autograd._profiler_enabled() reads this thread's state)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(
                PREFIX + self.name,
                ",".join(f"{k}={v}" for k, v in self.args.items()) or None)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dt = dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.top = self.parent
        if self.parent is not None:
            self.parent.child += dt
        tally = _local.tally
        if tally is not None:
            host = tally["host_s"]
            host[self.name] = host.get(self.name, 0.0) + dt - self.child


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; the seconds it blocks count as a device wait."""
    t0 = time.perf_counter()
    out = t.cpu()
    count(device_wait_s=time.perf_counter() - t0)
    return out


def sync(event) -> None:
    """``event.synchronize()``, counted as a device wait."""
    t0 = time.perf_counter()
    event.synchronize()
    count(device_wait_s=time.perf_counter() - t0)

"""What the traced run records, and how the profiler's trace is reduced.

:class:`Recorder` wraps the calls into each layer of the program from the
outside, for the length of one run: it names them as spans in the
profiler's trace (``annbench.span.<layer>``), keeps the engine's
``QueryStats`` of every batch, and names every call into a kernel entry of
``repro_torch.kernels.ops`` by the entry and the least bytes and operations
that call needs, worked out from its operands' shapes (``roofline.py``):
``annbench.op.<entry>:<bytes>:<operations>``. A call into an entry from
inside another (``or_scatter_new`` calls ``or_scatter_``) belongs to the
outer one.

:func:`reduce_trace` reads the profiler's Chrome trace: the device's busy
time (the union of kernel, memset and memcpy intervals), its operations by
time, its idle gaps named by the innermost span the host was in, the host's
top-level PyTorch operator calls, and the device time of the kernels each
entry call launched (a kernel belongs to the call whose span holds the host
launch that the kernel's correlation id names).
"""
from __future__ import annotations

import bisect
import collections
import functools
import heapq
import json
import threading

import torch

from annbench import roofline

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "annbench.span."
OP = "annbench.op."


class Recorder:
    """Layer spans, engine stats and kernel-entry shapes of one run."""

    def __init__(self):
        self.query_stats: list = []         # QueryStats of every batch
        self._depth = threading.local()
        self._undo: list = []

    def _patch(self, owner, name: str, wrapper) -> None:
        self._undo.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapper)

    def _span(self, owner, name: str, span: str) -> None:
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with torch.profiler.record_function(SPAN + span):
                return fn(*args, **kw)
        self._patch(owner, name, wrapper)

    def _entry(self, ops, name: str) -> None:
        fn = getattr(ops, name)
        cost = roofline.ENTRIES[name]
        depth = self._depth

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if getattr(depth, "n", 0):
                return fn(*args, **kw)
            nbytes, nops = cost(*args, **kw)
            depth.n = 1
            try:
                with torch.profiler.record_function(
                        f"{OP}{name}:{nbytes}:{nops}"):
                    return fn(*args, **kw)
            finally:
                depth.n = 0
        self._patch(ops, name, wrapper)

    def install(self, server, engine) -> None:
        from repro_torch.core import prefilter, search
        from repro_torch.kernels import ops
        for name in roofline.ENTRIES:
            self._entry(ops, name)
        self._span(search, "run_hops", "search.run_hops")
        self._span(prefilter, "prefilter_search", "prefilter.search")
        execute_batch = server._execute

        @functools.wraps(execute_batch)
        def flush(batch, *args, **kw):
            # the span names its batch's size, for the calls per query
            with torch.profiler.record_function(
                    f"{SPAN}server.flush:{len(batch)}"):
                return execute_batch(batch, *args, **kw)
        self._patch(server, "_execute", flush)
        if engine.disk_store is not None:
            self._span(engine.disk_store, "fetch", "disk.fetch")
        execute = engine.execute
        stats = self.query_stats

        @functools.wraps(execute)
        def traced_execute(*args, **kw):
            with torch.profiler.record_function(SPAN + "engine.execute"):
                out = execute(*args, **kw)
            stats.append(out[2])
            return out
        self._patch(engine, "execute", traced_execute)

    def remove(self) -> None:
        for owner, name, old in reversed(self._undo):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo.clear()


def make_profiler():
    """A profiler of the host and the card that records every thread (the
    server flushes on its own worker thread)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(spans: list, points: list) -> list:
    """For each time in ``points`` (ascending), the name of the span with
    the latest start among those that hold it, or None."""
    out, heap, i = [], [], 0
    spans = sorted(spans)
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            s, t, name = spans[i]
            heapq.heappush(heap, (-s, t, name))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def reduce_trace(path: str) -> dict:
    """The numbers the per-layer readers need, from one Chrome trace.

    Times are in seconds. Returns ``busy_s``, ``window_s`` (first to last
    event of the trace), ``device_ops`` and ``idle_gaps`` (each the ten
    largest [name, seconds]), ``host_ops`` (top-level PyTorch operator
    calls), ``flush_ops`` and ``flush_queries`` (those calls inside the
    server's flushes, and the queries of those flushes), ``flushes`` (for
    each flush in the order run: its queries, its top-level calls, the
    device's busy seconds inside it and its seconds), and over the
    kernel-entry calls whose kernels were found,
    ``entry_least_s`` (their least time), ``entry_device_s`` (their
    kernels' device time), ``entry_matched`` (how many), beside
    ``entry_calls`` (all of them)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    dev, spans = [], []
    calls = collections.defaultdict(list)   # tid -> [(start, end, name)]
    cpu = collections.defaultdict(list)
    launches = {}
    lo, hi = float("inf"), float("-inf")
    for e in events:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args", {})
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation" and name.startswith(SPAN):
            spans.append((ts, ts + dur, name[len(SPAN):], e.get("tid")))
        elif cat == "user_annotation" and name.startswith(OP):
            calls[e.get("tid")].append((ts, ts + dur, name[len(OP):]))
        elif cat == "cpu_op":
            cpu[e.get("tid")].append((ts, ts + dur))

    busy = _union([(s, t) for s, t, _, _ in dev])
    by_name: dict = collections.defaultdict(float)
    for s, t, name, _ in dev:
        by_name[name] += (t - s) * 1e-6
    gaps: dict = collections.defaultdict(float)
    pairs = list(zip(busy, busy[1:]))
    names = _innermost([(a, b, n.split(":")[0]) for a, b, n, _ in spans],
                       [(a[1] + b[0]) / 2 for a, b in pairs])
    for (a, b), name in zip(pairs, names):
        gaps[name or "outside_spans"] += (b[0] - a[1]) * 1e-6

    top = {}                    # tid -> starts of its top-level ops
    for tid, evs in cpu.items():
        end, starts = float("-inf"), []
        for s, t in sorted(evs):
            if s >= end:
                starts.append(s)
            end = max(end, t)
        top[tid] = starts
    # calls per query over the server's flushes (the trace holds them
    # whole: it starts before a round is sent and stops when it is back)
    busy_starts = [b[0] for b in busy]
    flushes = []
    for s, t, name, tid in sorted(spans):
        if name.startswith("server.flush:"):
            starts = top.get(tid, [])
            ops = (bisect.bisect_right(starts, t)
                   - bisect.bisect_left(starts, s))
            # the device's busy time inside the flush
            held = 0.0
            for a, b in busy[max(0, bisect.bisect_right(busy_starts, s)
                                 - 1):bisect.bisect_right(busy_starts, t)]:
                held += max(0.0, min(b, t) - max(a, s))
            flushes.append([int(name.split(":")[1]), ops, held * 1e-6,
                            (t - s) * 1e-6])

    # device time of each entry call: its kernels are those whose host
    # launch lies inside the call's span on the same thread
    for v in calls.values():
        v.sort()
    starts = {tid: [c[0] for c in v] for tid, v in calls.items()}
    call_dev: dict = collections.defaultdict(float)
    for s, t, _, corr in dev:
        tid, ts = launches.get(corr, (None, None))
        if tid not in calls:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and calls[tid][i][1] >= ts:
            call_dev[(tid, i)] += (t - s) * 1e-6
    least = 0.0
    for tid, i in call_dev:
        _, nbytes, nops = calls[tid][i][2].split(":")
        least += roofline.least_seconds(float(nbytes), float(nops))
    return {"busy_s": sum(t - s for s, t in busy) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "device_ops": _top(by_name), "idle_gaps": _top(gaps),
            "host_ops": sum(len(v) for v in top.values()),
            "flush_ops": sum(f[1] for f in flushes),
            "flush_queries": sum(f[0] for f in flushes),
            "flushes": flushes,
            "entry_least_s": least,
            "entry_device_s": sum(call_dev.values()),
            "entry_matched": len(call_dev),
            "entry_calls": sum(len(v) for v in calls.values())}

"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to a configuration, a traffic mix, a cell's limits
or a per-layer metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (corpus sizes and numeric
  fields, the program's ``IndexConfig``, ``SearchConfig``,
  ``StorageConfig`` and ``ServerConfig`` values, ``store`` "device" or
  "disk");
- ``traffic/<mix>.json``: the parameters ``loadgen.py`` reads;
- ``limits/<cell>.json``: the limits of ``judge.py``'s numbers;
- ``metrics/<metric>.py``: a ``read(obs)`` that returns the metric's value
  from the run's observations, or None where it finds nothing to read.

The observations a reader gets (``obs``): ``build_times`` (the engine's
seconds by stage), ``server`` (``ServerStats`` counters' change over the
window), ``disk`` (``DiskRecordStore.delta`` over the window, None on the
device backend), ``pages_read`` (the bytes the process's read system
calls returned in the window, from the kernel's own accounting, in the
disk tier's 4 KB pages; None on the device backend), ``completed``
(requests sent in the window and answered), ``qps`` (``stats.qps`` over
the window, in a traced run with its traced rounds), and in a traced run
``query_stats`` (the engine's ``QueryStats`` of every batch of the window)
and ``trace`` (``trace.reduce_trace``'s numbers).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from annbench import judge, loadgen, stats, trace
from annbench.corpus import make_corpus
from annbench.reference import Reference

HERE = Path(__file__).resolve().parent
WARM_ROUNDS = 1        # closed-loop rounds of every client before the window
TRACE_ROUNDS = 3       # closed-loop rounds the traced run records whole
DRAIN_S = 60.0         # wait for answers due in the window past its close
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_files(bench: dict, cell: str, root: Path) -> dict:
    """The cell's entry and the parsed files it names."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as fh:
        config = json.load(fh)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    with open(HERE / "limits" / f"{cell}.json") as fh:
        limits = json.load(fh)
    return {"workload": w, "config": config, "traffic": traffic,
            "limits": limits}


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "annbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def make_requests(pool: loadgen.Pool, traffic: dict) -> list:
    """One request a pool row: its tags ANDed, then a range over each field
    whose range is not open."""
    from repro_torch.api import Num, SearchRequest, Tag
    out = []
    for vec, tags, ranges in zip(pool.vectors, pool.tags, pool.ranges):
        terms = [Tag("tag") == int(t) for t in tags[tags >= 0]]
        terms += [Num(name).between(float(lo), float(hi))
                  for name, (lo, hi) in zip(pool.fields, ranges)
                  if lo > -np.inf or hi < np.inf]
        expr = None
        for term in terms:
            expr = term if expr is None else expr & term
        out.append(SearchRequest(query=vec, filter=expr,
                                 **traffic["request"]))
    return out


def build_index(config: dict, corpus, device, slab_dir=None):
    """The program's index over the corpus, records on the device or spilled
    to slab files under ``slab_dir``."""
    from repro_torch.api import Index, Schema
    from repro_torch.core.engine import (FilteredANNEngine, IndexConfig,
                                         SearchConfig)
    from repro_torch.storage import StorageConfig
    engine = FilteredANNEngine.build(
        corpus.vectors, corpus.tag_offsets, corpus.tag_flat, corpus.vocab,
        corpus.numerics, IndexConfig(**config["index"]), device=device)
    if config["store"] == "disk":
        engine.to_disk(slab_dir, StorageConfig(**config["storage"]))
    vocab = {("tag", t): t for t in range(corpus.vocab)}
    return Index(engine, vocab, Schema(tags=("tag",),
                                       nums=corpus.num_names),
                 SearchConfig(**config["search"]))


def chars_read() -> int:
    """Bytes that this process's read system calls (``read``, ``pread``,
    ``readv``, ...) have returned, all threads together, as the kernel
    counts them (``rchar`` of ``/proc/self/io``; gVisor names that field
    ``char``)."""
    with open("/proc/self/io") as fh:
        fields = dict(line.split(":", 1) for line in fh if ":" in line)
    for key in ("rchar", "char"):
        if key in fields:
            return int(fields[key])
    raise OSError("/proc/self/io holds no rchar")


def thread_cpu() -> dict:
    """{native thread id: CPU seconds (user and system)} of this process's
    threads, from ``/proc/self/task``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue            # the thread ended
        out[int(tid)] = (int(fields[11]) + int(fields[12])) / tick
    return out


class HostWatch:
    """What the host did over the window: the process's CPU time by
    thread, its involuntary context switches, and Python's garbage
    collections, printed beside the wall time."""

    def __init__(self, clock):
        self._clock = clock
        self.gc_s, self.gc_n, self._gc_t0 = 0.0, 0, None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n += 1

    def start(self) -> None:
        self.t0, self.ru0 = self._clock(), resource.getrusage(
            resource.RUSAGE_SELF)
        self.cpu0 = thread_cpu()
        gc.callbacks.append(self._on_gc)

    def stop(self, named: dict) -> str:
        """One line; ``named`` maps a name to a native thread id."""
        gc.callbacks.remove(self._on_gc)
        wall = self._clock() - self.t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = thread_cpu()
        by = {t: c - self.cpu0.get(t, 0.0) for t, c in cpu.items()}
        parts = [f"{n} {by.pop(t, 0.0):.2f}" for n, t in named.items()]
        others = sorted(by.values(), reverse=True)
        top = " ".join(f"{c:.2f}" for c in others[:4])
        return (f"window host: wall {wall:.3f} s, process cpu user "
                f"{ru.ru_utime - self.ru0.ru_utime:.3f} s sys "
                f"{ru.ru_stime - self.ru0.ru_stime:.3f} s, involuntary "
                f"switches {ru.ru_nivcsw - self.ru0.ru_nivcsw}, gc "
                f"{self.gc_s:.3f} s in {self.gc_n} collections; cpu s by "
                f"thread: {', '.join(parts)}, {len(others)} others "
                f"{sum(others):.2f} (top {top})")


def forbidden_modules(names=None) -> list:
    """The top-level names of ``names`` (default: the loaded modules) that
    are JAX's or the JAX package's, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device,
             root: Path, t_start: float, files: dict | None = None,
             clock=time.perf_counter) -> dict:
    """One run. Returns the result's fields, with ``checks`` last."""
    bench = load_bench(root)
    files = files or cell_files(bench, cell, root)
    config, traffic = files["config"], files["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    corpus = make_corpus(config["corpus"], seed, int(traffic["pool"]))
    pool = loadgen.make_pool(traffic, corpus, seed)
    requests = make_requests(pool, traffic)
    slab_dir = tempfile.mkdtemp(prefix="annbench-slabs-") \
        if config["store"] == "disk" else None
    try:
        index = build_index(config, corpus, dev, slab_dir)
        out = _serve(index, config, traffic, requests, seconds, traced,
                     dev, t_start, clock)
        ds = index.engine.disk_store
        del index
        if ds is not None:
            ds.close()
        del ds
    finally:
        if slab_dir is not None:
            shutil.rmtree(slab_dir, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    records, t0 = out.pop("records"), out.pop("t0")
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, config["index"]["max_labels"], dev)
    used = sorted({r["pool"] for r in records})
    k = int(traffic["request"]["k"])
    exact_ids = np.full((len(pool), k), -1, np.int64)
    exact_ids[used] = ref.search(pool.vectors[used], pool.tags[used],
                                 pool.ranges[used], k)[0]
    answered = [r for r in records if r["result"] is not None]
    answers = [(r["pool"], np.asarray(r["result"].ids),
                np.asarray(r["result"].dists)) for r in answered]
    failed = len(records) - len(answered)
    numbers = judge.compare(answers, failed, pool.vectors, pool.tags,
                            pool.ranges, exact_ids, ref)
    correct, checks = judge.verdict(numbers, files["limits"])

    obs = out.pop("obs")
    obs["completed"] = len(answered)
    obs["qps"] = stats.qps(answered, t0)
    result = {"correct": correct, "attempted": len(records),
              "failed": failed}
    metrics = {}
    if traced:
        for m in cell_metrics(bench, cell, "per_layer"):
            v = metric_reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {
            "qps": obs["qps"],
            "recall_at_10": 1.0 - numbers["recall_shortfall"],
            "setup_s": out["setup_s"],
        }
        if obs["pages_read"] is not None:
            values["pages_per_query"] = obs["pages_read"] / max(
                1, len(answered))
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = out["device"]
    if traced:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def _serve(index, config, traffic, requests, seconds, traced, dev, t_start,
           clock) -> dict:
    """Set-up's last part, the window, and what the window left to read."""
    from repro_torch.serve import SearchServer, ServerConfig
    cuda = dev.type == "cuda"
    clients = int(traffic["clients"])
    server = SearchServer(index, ServerConfig(**config["server"]))
    try:
        t_ready = clock()
        server.warmup(requests[:clients], rungs=())
        t_ladder = clock()

        def submit(i):
            return server.submit(requests[i])

        # the warm-up sends the pool's last rows, the window its first
        loadgen.closed_loop(submit, clients, loadgen.ClientStreams(
            clients, len(requests), len(requests) - WARM_ROUNDS * clients),
            total=WARM_ROUNDS * clients, drain_s=DRAIN_S, clock=clock)
        print(f"set-up (s): index ready {t_ready - t_start:.3f}, warm-up "
              f"ladder {t_ladder - t_ready:.3f}, warm rounds "
              f"{clock() - t_ladder:.3f}", file=sys.stderr)
        prof = None
        if traced:
            # the profiler's first start pays its own set-up: pay it here
            warm = trace.make_profiler()
            warm.start()
            warm.stop()
            del warm
            prof = trace.make_profiler()
        if cuda:
            torch.cuda.synchronize(dev)
        ds = index.engine.disk_store
        before = server.stats()
        disk0 = ds.snapshot() if ds is not None else None
        watch = HostWatch(clock)
        watch.start()
        chars0 = chars_read()
        setup_s = clock() - t_start

        t0 = clock()
        close = t0 + seconds
        marks, rec = (), None
        if traced:
            # trace the window's rounds 2 to 1 + TRACE_ROUNDS whole: from
            # the first round's return to the last traced one's
            marks = ((clients, prof.start),
                     ((1 + TRACE_ROUNDS) * clients, prof.stop))
            rec = trace.Recorder()
            rec.install(server, index.engine)
        try:
            records = loadgen.closed_loop(
                submit, clients, loadgen.ClientStreams(clients,
                                                       len(requests)),
                close=close, marks=marks, drain_s=DRAIN_S, clock=clock)
        finally:
            if rec is not None:
                rec.remove()
        chars = chars_read() - chars0
        print(watch.stop({"main": threading.main_thread().native_id,
                          "server": server._worker.native_id}),
              file=sys.stderr)
        after = server.stats()
        ends = sorted({r["t_done"] for r in records
                       if r["t_done"] is not None and t0 <= r["t_done"]})
        rounds = [b - a for a, b in zip([t0] + ends, ends)]
        print("completion batches after the window's start (s): " + " ".join(
            f"{d:.3f}" for d in rounds), file=sys.stderr)
        obs = {"build_times": dict(index.engine.build_times),
               "server": {"completed": after.completed - before.completed,
                          "degraded_served": after.degraded_served
                          - before.degraded_served},
               "disk": (type(ds).delta(disk0, ds.snapshot())
                        if ds is not None else None),
               "pages_read": (chars / ds.layout.page_bytes
                              if ds is not None else None)}
        print(f"bytes read by the process in the window: {chars}"
              + (f" ({obs['pages_read']} pages; the disk tier counts "
                 f"{obs['disk']['pages_read']})" if ds is not None else ""),
              file=sys.stderr)
        device = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda
                  else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                      dev)) if cuda else 0}
        breakdown = None
        if traced:
            obs["query_stats"] = rec.query_stats
            fd, path = tempfile.mkstemp(suffix=".json",
                                        prefix="annbench-trace-")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                del prof
                red = trace.reduce_trace(path)
            finally:
                os.remove(path)
            obs["trace"] = red
            print("trace: " + json.dumps(
                {k: red[k] for k in ("busy_s", "window_s", "host_ops",
                                     "flush_ops", "flush_queries",
                                     "entry_calls", "entry_matched",
                                     "entry_least_s", "entry_device_s")}),
                  file=sys.stderr)
            print("traced flushes (queries, calls a query, idle share, s): "
                  + "; ".join(f"{q} {o / max(q, 1):.1f} "
                              f"{1 - b / max(d, 1e-12):.4f} {d:.3f}"
                              for q, o, b, d in red["flushes"]),
                  file=sys.stderr)
            # the profiler slows the host; the rounds it did not record
            # (the first, and those after the one that stopped it) give
            # the device's idle share at the untraced pace
            plain = rounds[:1] + rounds[TRACE_ROUNDS + 2:]
            if plain:
                pace = float(np.median(plain))
                print(f"idle share at the untraced pace: "
                      f"{1 - red['busy_s'] / TRACE_ROUNDS / pace:.4f} "
                      f"(median untraced round {pace:.3f} s)",
                      file=sys.stderr)
            device["busy_s"] = red["busy_s"]
            device["window_s"] = red["window_s"]
            breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
    finally:
        server.stop()
    return {"records": records, "t0": t0, "obs": obs,
            "setup_s": setup_s, "device": device, "breakdown": breakdown}

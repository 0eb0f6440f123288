"""The port's host spans and per-batch tally (``repro_torch.utils.trace``)
on the served path, on the CPU: the tally's counters are exact, a recording
profiler changes no answer and sees the spans nested as the code nests
them, a span with no profiler calls no torch operator, the metric readers
of the tally (``annbench/metrics``), the disk tier's host clocks, and the
server's flush counters."""
import bisect
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_port_helpers  # noqa: F401  (one intra-op thread a worker)
from repro_torch import api
from repro_torch.core import engine as teng
from repro_torch.core import search as tsearch
from repro_torch.core.selectors import stack_filters
from repro_torch.data.synth import make_filtered_dataset, make_selectors
from repro_torch.serve import SearchServer, ServerConfig
from repro_torch.utils import trace

HOP_SPANS = ("hop.rerank", "hop.expand", "hop.select", "hop.settle")
COUNTED = ("io_pages", "dist_comps", "hops", "fp_explored", "explored",
           "n_valid", "faults", "retries", "degraded")
# two configs, so that each route splits into two groups
SCFGS = (teng.SearchConfig(hop_chunk=8),
         teng.SearchConfig(hop_chunk=8, l=40, policy="post"))


@pytest.fixture(scope="module")
def built():
    ds = make_filtered_dataset(n=2000, d=32, n_queries=24, n_labels=60,
                               seed=0)
    cfg = teng.IndexConfig(r=16, r_dense=96, l_build=32, pq_m=8,
                           max_labels=16, ql=8, cap=2048)
    e = teng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                     ds.label_flat, ds.n_labels, ds.values,
                                     cfg, device="cpu")
    return ds, e


def _batch(ds, e, n=6):
    sels = []
    for wl in ("label", "label_and", "range", "hybrid"):
        sels += make_selectors(ds, e, wl, n_queries=n)
    queries = np.concatenate([ds.queries[:n]] * 4)
    scfgs = [SCFGS[i % 2] for i in range(len(sels))]
    return queries, sels, scfgs


def _group_keys(e, sels, scfgs):
    """The (mechanism, pool bucket, config) keys ``execute`` groups by."""
    keys = set()
    for s, sc in zip(sels, scfgs):
        r = e._route(s.plan(e.config.ql, e.config.cap, e.config.qr), sc)
        eff = 1 << max(5, int(np.ceil(np.log2(max(r.effective_l, 1)))))
        keys.add((r.mechanism, min(eff, sc.max_pool), sc))
    return keys


class _Ops(TorchDispatchMode):
    """Counts the torch operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_tally_counts_are_exact(built):
    """``groups`` is the number of distinct group keys, ``row_hops_live``
    the sum of the graph-routed queries' hops, and every graph query hops
    inside the rows dispatched."""
    ds, e = built
    queries, sels, scfgs = _batch(ds, e)
    _, _, stats = e.execute(queries, sels, scfgs)
    t = stats.trace
    assert t["groups"] == len(_group_keys(e, sels, scfgs)) >= 3
    graph = [m != "pre" for m in stats.mechanism]
    assert sum(graph) >= 4
    assert t["row_hops_live"] == int(stats.hops.sum()) > 0
    assert 0 < t["row_hops_live"] <= t["row_hops_dispatched"]
    assert t["hop_steps"] > 0 and t["hop_steps"] % 8 == 0
    assert set(HOP_SPANS) <= set(t["host_s"])
    assert {"engine.execute", "engine.plan", "engine.group",
            "search.hops", "search.seed"} <= set(t["host_s"])
    assert all(v >= 0 for v in t["host_s"].values())


@pytest.mark.parametrize("async_readback", [True, False])
def test_hop_counters_match_the_chunk_log(built, async_readback):
    """The pipelined search's hop steps and dispatched row-hops are the
    chunk log's: its last entry's hops, and each chunk's hops times the
    width it was observed at when it came back (compaction changes the
    width only between chunks)."""
    ds, e = built
    sels = make_selectors(ds, e, "label", n_queries=12)
    qf = stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                        for s in sels])
    p = tsearch.SearchParams(l_search=32, k=10, max_hops=64, mode="post")
    with trace.batch() as t:
        res, log = tsearch.filtered_search_pipelined(
            e.store, e.codes, e.codebook, e.mem, qf, ds.queries[:12],
            e.medoid, p, hop_chunk=4, min_bucket=2,
            async_readback=async_readback, collect_trace=True)
    assert len(log) > 2
    assert t["hop_steps"] == log[-1]["hop"] > 0
    assert t["row_hops_dispatched"] == sum(
        (b["hop"] - a["hop"]) * b["bucket"] for a, b in zip(log, log[1:]))
    assert t["row_hops_dispatched"] >= int(res.hops.sum()) > 0
    assert t["groups"] == 0        # no engine around the search


def test_explored_tallies_equal_the_query_stats(built):
    """``explored`` and ``fp_explored`` are the batch's ``QueryStats``
    sums: the records its ``in`` and ``post`` rows explored and those that
    exact verification found invalid (the ``pre`` route counts none); the
    range and hybrid rows let some invalid record in."""
    ds, e = built
    queries, sels, scfgs = _batch(ds, e)
    _, _, stats = e.execute(queries, sels, scfgs)
    t = stats.trace
    graph = np.array([m != "pre" for m in stats.mechanism])
    assert graph.any() and not graph.all()
    assert t["explored"] == int(stats.explored.sum()) \
        == int(stats.explored[graph].sum()) > 0
    assert t["fp_explored"] == int(stats.fp_explored.sum()) \
        == int(stats.fp_explored[graph].sum())
    assert 0 < t["fp_explored"] < t["explored"]
    # the benchmark's reader of the two; a tally without them (a program
    # that does not count them) gives nothing to read
    from annbench import harness
    read = harness.metric_reader("search.fp_explored_share")
    assert read(_obs([t])) == t["fp_explored"] / t["explored"]
    old = {k: v for k, v in t.items() if k not in ("explored", "fp_explored")}
    assert read(_obs([old])) is None


def test_profiler_changes_no_answer(built):
    """ids, distances and every ``QueryStats`` counter are the same with a
    profiler recording as without one."""
    ds, e = built
    queries, sels, scfgs = _batch(ds, e, n=3)
    plain = e.execute(queries, sels, scfgs)
    (traced, _) = _profiled(lambda: e.execute(queries, sels, scfgs))
    for a, b in zip(plain[0] + plain[1], traced[0] + traced[1]):
        np.testing.assert_array_equal(a, b)
    assert plain[2].mechanism == traced[2].mechanism
    for f in COUNTED:
        np.testing.assert_array_equal(getattr(plain[2], f),
                                      getattr(traced[2], f), err_msg=f)
    for k in trace.COUNTERS:
        assert plain[2].trace[k] == traced[2].trace[k], k


def test_profiler_trace_nests_the_spans(built, tmp_path):
    """The exported trace holds ``engine.execute`` ⊃ ``engine.group`` ⊃
    ``search.hops`` ⊃ ``hop.*`` on one thread, and each hop phase span
    holds the operators it dispatched."""
    ds, e = built
    queries, sels, scfgs = _batch(ds, e, n=3)
    _, prof = _profiled(lambda: e.execute(queries, sels, scfgs))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [v for v in json.loads(path.read_text())["traceEvents"]
              if v.get("ph") == "X"]
    spans = {}
    for v in events:
        if v.get("cat") == "user_annotation" and \
                v["name"].startswith(trace.PREFIX):
            spans.setdefault(v["name"][len(trace.PREFIX):], []).append(
                (float(v["ts"]), float(v["ts"]) + float(v["dur"]),
                 v["tid"]))
    (top,) = spans["engine.execute"]
    ops = sorted(float(v["ts"]) for v in events
                 if v.get("cat") == "cpu_op" and v["tid"] == top[2])

    def inside(inner, outer):
        # spans of one name do not overlap: the holder is the last to start
        starts = [o[0] for o in spans[outer]]
        i = bisect.bisect_right(starts, inner[0]) - 1
        return i >= 0 and inner[1] <= spans[outer][i][1]

    for name, outer in (("engine.group", "engine.execute"),
                        ("search.hops", "engine.group"),
                        *((h, "search.hops") for h in HOP_SPANS)):
        assert spans.get(name), name
        spans[name].sort()
        assert all(s[2] == top[2] for s in spans[name]), name
        assert all(inside(s, outer) for s in spans[name]), name
    for h in HOP_SPANS:
        assert all(bisect.bisect_right(ops, s[1])
                   > bisect.bisect_left(ops, s[0]) for s in spans[h]), h


def test_span_without_profiler_calls_no_operator():
    """With no profiler a span, a batch and a counter dispatch no torch
    operator; ``record_function`` itself dispatches two."""
    with _Ops() as counted:
        with trace.batch() as t, trace.span("outer", a=1):
            with trace.span("inner"):
                trace.count(hop_steps=1)
    assert counted.n == 0
    assert t["hop_steps"] == 1 and set(t["host_s"]) == {"outer", "inner"}
    with _Ops() as control:
        with torch.profiler.record_function("x"):
            pass
    assert control.n == 2


def test_self_time_excludes_children(monkeypatch):
    """A span's tally is its seconds less its children's; outside a batch
    nothing is recorded."""
    clock = iter([0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 10.0, 12.0, 13.0, 14.0])
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(clock))
    with trace.batch() as t:
        with trace.span("a"):            # 0 .. 12
            with trace.span("b"):        # 1 .. 3
                pass
            with trace.span("b"):        # 4 .. 10, blocked 5 .. 6
                trace.sync(type("E", (), {"synchronize": lambda s: None})())
    assert t["host_s"] == {"a": 4.0, "b": 8.0}
    assert t["device_wait_s"] == 1.0
    with trace.span("c"):
        trace.count(hop_steps=5)
    assert "c" not in t["host_s"] and t["hop_steps"] == 0


def _obs(tallies, disk=None):
    class QS:
        def __init__(self, t):
            self.trace = t
    return {"query_stats": [QS(t) for t in tallies], "disk": disk}


READER_CASES = {
    "search.hop_steps_per_batch": 300.0,
    "search.live_row_share": 0.25,
    "search.fp_explored_share": 0.15,
    "search.host_us_per_hop_step": 2000.0,
    "engine.groups_per_batch": 3.0,
    "engine.device_wait_share": 0.1,
    "disk.fetch_us_per_record": 50.0,
    "disk.read_us_per_page": 4.0,
}


@pytest.mark.parametrize("name", sorted(READER_CASES))
def test_readers_on_a_hand_built_obs(name):
    """Each of the tally's readers on two batches, and None where its
    denominator is 0 or the program leaves its field out."""
    from annbench import harness
    read = harness.metric_reader(name)
    t1 = dict(trace.new_tally(), groups=2, hop_steps=256,
              row_hops_live=1000, row_hops_dispatched=6000,
              explored=400, fp_explored=100,
              device_wait_s=0.05,
              host_s={"search.hops": 0.2, "hop.rerank": 0.3,
                      "hop.expand": 0.1, "disk.fetch": 0.4})
    t2 = dict(trace.new_tally(), groups=4, hop_steps=344,
              row_hops_live=2000, row_hops_dispatched=6000,
              explored=600, fp_explored=50,
              device_wait_s=0.15,
              host_s={"hop.select": 0.35, "hop.settle": 0.25,
                      "engine.execute": 0.4})
    disk = {"fetch_us": 5000.0, "records_fetched": 100,
            "pread_us": 800.0, "pages_read": 200}
    assert read(_obs([t1, t2], disk)) == pytest.approx(READER_CASES[name])
    assert read(_obs([], {k: 0 for k in disk})) is None
    # a program without the tally or the disk clocks: nothing to read
    assert read(_obs([None], {"records_fetched": 1, "pages_read": 1})) \
        is None
    assert read({"disk": None}) is None


@pytest.fixture(scope="module")
def disk_engine(built, tmp_path_factory):
    _, e = built
    d = teng.FilteredANNEngine.from_arrays(e.arrays(), e.config,
                                           device="cpu")
    d.to_disk(str(tmp_path_factory.mktemp("slabs")))
    yield d
    d.disk_store.close()


def test_disk_clocks_advance_and_reach_the_delta(built, disk_engine):
    """``fetch_us`` and ``pread_us`` grow with the fetches and page reads
    and reach ``QueryStats.disk``; the delta carries no ``p50_page_us``;
    the disk spans reach the tally."""
    ds, _ = built
    queries, sels, scfgs = _batch(ds, disk_engine)
    store = disk_engine.disk_store
    before = store.snapshot()
    _, _, stats = disk_engine.execute(queries, sels, scfgs)
    after = store.snapshot()
    d = stats.disk
    assert "p50_page_us" not in d and "p50_page_us" in after
    assert d["records_fetched"] > 0 and d["pages_read"] > 0
    assert d["fetch_us"] > 0 and d["pread_us"] > 0
    assert d["fetch_us"] > d["pread_us"]
    for k in ("fetch_us", "pread_us"):
        assert d[k] == pytest.approx(after[k] - before[k]), k
    assert stats.trace["host_s"]["disk.fetch"] > 0
    assert stats.trace["device_wait_s"] >= 0


def test_server_counts_flushes_and_waits(built):
    """``ServerStats`` counts the worker's flushes and the requests' queue
    wait."""
    ds, e = built
    index = api.Index(e, {("tag", i): i for i in range(ds.n_labels)},
                      api.Schema(tags=("tag",), nums=("value",)))
    reqs = [api.SearchRequest(query=ds.queries[i],
                              filter=api.Tag("tag") == int(i % 7))
            for i in range(8)]
    with SearchServer(index, ServerConfig(max_batch=4,
                                          max_delay_s=0.05)) as srv:
        for h in [srv.submit(r) for r in reqs]:
            h.result(timeout=60)
        st = srv.stats()
    assert st.completed == len(reqs)
    assert 2 <= st.flushes <= len(reqs)
    assert st.queue_wait_us > 0

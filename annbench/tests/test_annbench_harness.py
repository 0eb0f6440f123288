"""The harness's arithmetic, its traffic and its files, on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from annbench import harness, loadgen, stats
from annbench.corpus import make_corpus
from annbench.reference import Reference, padded_tags

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SPEC = {"n": 600, "dim": 192, "vocab": 50, "zipf_a": 1.3, "tags_mean": 4.0,
        "tags_max": 16, "latent_dim": 24, "n_clusters": 64,
        "centre_scale": 1.0, "cluster_spread": 1.0, "noise": 0.1}
TRAFFIC = {"kind": "closed", "clients": 4, "pool": 64,
           "filter_tags": {"1": 0.5, "2": 0.5},
           "request": {"k": 10, "l": 32, "policy": "speculative"}}


def test_pool_is_deterministic_for_a_seed():
    c = make_corpus(SPEC, 5, 64)
    a = loadgen.make_pool(TRAFFIC, c, 5)
    b = loadgen.make_pool(TRAFFIC, c, 5)
    other = loadgen.make_pool(TRAFFIC, c, 6)
    np.testing.assert_array_equal(a.tags, b.tags)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    assert not np.array_equal(a.tags, other.tags)
    n_tags = (a.tags >= 0).sum(1)
    assert (n_tags == 1).sum() == 32 and (n_tags == 2).sum() == 32
    two = a.tags[n_tags == 2]
    assert np.all(two[:, 0] != two[:, 1])
    s = loadgen.ClientStreams(4, 64)
    rounds = [[s.next(c) for c in range(4)] for _ in range(16)]
    assert sorted(sum(rounds, [])) == list(range(64))
    for r in rounds:
        assert sorted(n_tags[r]) == [1, 1, 2, 2]
    assert loadgen.ClientStreams(4, 64, 60).next(0) == 60


class _Handle:
    def __init__(self, t):
        self.t = t
        self.done = False

    def result(self, timeout=None):
        return self.t


def test_closed_loop_keeps_every_client_busy_and_drains():
    clock = [0.0]
    handles = []

    def submit(i):
        h = _Handle(i)
        h.done = True          # served at once; each wait costs 10 ms
        clock[0] += 0.01
        handles.append(h)
        return h
    recs = loadgen.closed_loop(submit, 3, loadgen.ClientStreams(3, 16),
                               close=1.0, clock=lambda: clock[0])
    assert {r["client"] for r in recs} == {0, 1, 2}
    assert all(r["t_done"] is not None and r["result"] is not None
               for r in recs)
    assert len(recs) == len(handles)
    assert max(r["t_submit"] for r in recs) < 1.0


def _recs(times):
    return [{"t_submit": s, "t_done": d} for s, d in times]


def test_metrics_take_every_request_so_a_stall_moves_them():
    steady = _recs([(i * 0.1, i * 0.1 + 0.1) for i in range(100)])
    # the same work, one request of it held up 2 s before it returns
    stalled = steady[:99] + _recs([(9.9, 12.0)])
    assert stats.qps(steady, 0.0) == pytest.approx(10.0)
    assert stats.qps(stalled, 0.0) == pytest.approx(100 / 12.0)
    # a request that never came back is not counted as served
    lost = steady[:99] + [{"t_submit": 9.9, "t_done": None}]
    assert stats.qps(lost, 0.0) == pytest.approx(99 / 9.9)
    ex = np.array([1, 2, 3, -1])
    assert stats.recall(np.array([3, 2, 9, -1]), ex) == pytest.approx(2 / 3)
    assert stats.recall(np.array([5]), np.array([-1, -1])) is None
    assert stats.mean_recall([(np.array([1]), np.array([1, 2])),
                              (np.array([1]), np.array([-1]))]) == 0.5


def test_reference_exact_top_k_on_a_tiny_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    tags = [sorted(set(rng.integers(0, 5, rng.integers(1, 4)).tolist()))
            for _ in range(300)]
    offsets = np.zeros(301, np.int64)
    offsets[1:] = np.cumsum([len(t) for t in tags])
    flat = np.array([t for ts in tags for t in ts], np.int32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    qt = np.array([[0, -1], [1, 2], [3, 4], [4, -1], [0, 1], [2, -1]],
                  np.int32)
    nums = np.zeros((300, 0), np.float32)     # no numeric field
    open_r = loadgen.open_ranges(6, 0)
    ref = Reference(x, offsets, flat, nums, 16, "cpu")
    ids, d = ref.search(q, qt, open_r, 5)
    for i in range(6):
        ok = np.array([all(t in tags[n] for t in qt[i] if t >= 0)
                       for n in range(300)])
        dist = ((x.astype(np.float64) - q[i]) ** 2).sum(1)
        want = np.flatnonzero(ok)[np.argsort(dist[ok], kind="stable")][:5]
        got = ids[i][ids[i] >= 0]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(d[i][:got.size], dist[want], rtol=1e-12)
        assert ref.filter_ok(qt[i:i + 1], open_r[i:i + 1], got[None]).all()
    assert padded_tags(offsets, flat, 16).shape == (300, 16)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    read = harness.metric_reader(metric)
    assert read({"server": {"completed": 0, "degraded_served": 0},
                 "disk": None, "build_times": {}, "completed": 0}) is None


def test_readers_on_observations():
    class QS:
        mechanism = ["pre", "in", "post", "in"]
        hops = np.array([0, 10, 20, 30])
    obs = {"server": {"completed": 8, "degraded_served": 2},
           "disk": {"hits": 3, "misses": 1, "pages_read": 10,
                    "readahead_pages": 4},
           "build_times": {"a": 1.0, "b": 2.5}, "query_stats": [QS()],
           "trace": {"busy_s": 1.0, "window_s": 4.0, "host_ops": 120,
                     "flush_ops": 100, "flush_queries": 10,
                     "entry_least_s": 1.0, "entry_device_s": 4.0},
           "completed": 8, "qps": 12.5}
    want = {"server.degraded_share": 0.25, "engine.pre_share": 0.25,
            "search.hops_per_query": 20.0, "dispatch.calls_per_query": 10.0,
            "disk.hit_rate": 0.75, "disk.readahead_share": 0.4,
            "kernels_roofline": 25.0, "device.idle_share": 0.75,
            "build.seconds": 3.5, "server.qps": 12.5,
            "engine.pre_share.pre_route": 0.25,
            "dispatch.calls_per_query.pre_route": 10.0}
    assert {m["name"] for m in BENCH["per_layer"]} == set(want)
    for name, v in want.items():
        assert harness.metric_reader(name)(obs) == pytest.approx(v), name


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    files = harness.cell_files(BENCH, cell, ROOT)
    assert files["workload"]["chips"] == 1
    cfg = files["config"]
    assert cfg["store"] in ("device", "disk")
    assert set(files["limits"]) == {"unanswered", "filter_violations",
                                    "duplicate_ids", "dist_gap",
                                    "recall_shortfall"}
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    "end_to_end")}
    per = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                   "per_layer")}
    assert {"setup_s", "recall_at_10"} <= e2e
    # the rate is end to end, or per layer where it is too noisy to bound
    assert ("qps" in e2e) != ("server.qps" in per)
    assert ("pages_per_query" in e2e) == (cfg["store"] == "disk")


def test_run_refuses_a_machine_without_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "annbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""


def test_reduce_trace_on_a_small_trace(tmp_path):
    from annbench import trace
    ev = [
        # worker thread 7: one flush of 4 queries holding two top-level
        # ops (one with a nested op) and one entry call that launched a
        # kernel of 2 us
        {"ph": "X", "cat": "user_annotation", "name":
         "annbench.span.server.flush:4", "ts": 0, "dur": 100, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::a", "ts": 1, "dur": 10,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::b", "ts": 2, "dur": 2,
         "tid": 7},
        {"ph": "X", "cat": "user_annotation", "name":
         "annbench.op.pq_scan:3350000:0", "ts": 20, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 21, "dur": 1, "tid": 7, "args": {"correlation": 5}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::c", "ts": 40, "dur": 5,
         "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 2,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 6,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::d", "ts": 2000,
         "dur": 10, "tid": 3},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce_trace(str(path))
    assert r["busy_s"] == pytest.approx(8e-6)
    assert r["window_s"] == pytest.approx(2010e-6)
    assert r["host_ops"] == 3
    assert (r["flush_ops"], r["flush_queries"]) == (2, 4)
    assert r["entry_matched"] == 1 and r["entry_calls"] == 1
    assert r["entry_device_s"] == pytest.approx(2e-6)
    assert r["entry_least_s"] == pytest.approx(1e-6)
    assert r["idle_gaps"] == [["server.flush", pytest.approx(18e-6)]]
    [(q, ops, held, span)] = r["flushes"]
    assert (q, ops) == (4, 2)
    assert held == pytest.approx(8e-6) and span == pytest.approx(100e-6)
    assert r["device_ops"][0] == ["k2", pytest.approx(6e-6)]


def test_the_host_counts_the_bytes_a_pread_returns(tmp_path):
    path = tmp_path / "slab"
    path.write_bytes(os.urandom(16 * 4096))
    fd = os.open(path, os.O_RDONLY)
    try:
        before = harness.chars_read()
        got = sum(len(os.pread(fd, 4096, i * 4096)) for i in (1, 5, 9))
        got += os.preadv(fd, [bytearray(8192)], 12 * 4096)
        read = harness.chars_read() - before
    finally:
        os.close(fd)
    assert got == 5 * 4096
    # the reading of /proc/self/io itself adds a few hundred bytes
    assert got <= read < got + 4096


def test_host_watch_reports_the_window():
    w = harness.HostWatch(harness.time.perf_counter)
    w.start()
    sum(i * i for i in range(10 ** 5))
    line = w.stop({"main": harness.threading.main_thread().native_id})
    assert line.startswith("window host: wall ")
    assert "main " in line and "gc " in line

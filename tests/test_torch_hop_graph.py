"""The hop loop's CUDA-graph path (``search.run_hops`` → ``_run_graphed``)
on the CPU: which calls take it, that the body it captures, stepped eagerly
on its static buffers, equals the eager loop bit for bit (on the device
backend and on the disk tier, whose fetch it makes once a hop), that a
capture leaves the hand-written kernel entries and the disk tier's host
fetch out of its graphs and a replay calls them between the graphs, and
that the tally's graph counters stay zero where no graph runs. The capture
and replay themselves run only on the card (``tests/test_torch_cuda.py``)."""
import threading
import types

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one intra-op thread a worker)
from repro_torch.core import engine as teng
from repro_torch.core import search as tsearch
from repro_torch.core.faults import FaultPlan
from repro_torch.core.selectors import stack_filters
from repro_torch.data.synth import make_filtered_dataset, make_selectors
from repro_torch.kernels import ops as tops
from repro_torch.storage import DiskRecordStore
from repro_torch.utils import trace


@pytest.fixture(scope="module")
def small():
    """A 600-record engine on the CPU and its label batch of 12 queries in
    the port's filter form."""
    ds = make_filtered_dataset(n=600, d=24, n_queries=12, n_labels=12,
                               seed=0)
    cfg = teng.IndexConfig(r=12, r_dense=48, l_build=24, pq_m=8)
    e = teng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                     ds.label_flat, ds.n_labels, ds.values,
                                     cfg, device="cpu")
    sels = make_selectors(ds, e, "label")
    qf = stack_filters([s.plan(cfg.ql, cfg.cap).qfilter for s in sels])
    return ds, e, qf


@pytest.fixture(scope="module")
def disk(small, tmp_path_factory):
    """The small engine's records spilled to slab files: a disk tier."""
    _, e, _ = small
    return DiskRecordStore.from_record_store(
        str(tmp_path_factory.mktemp("slabs")), e.store, n=e.n)


def _params(mode="spec_in", **kw):
    return tsearch.SearchParams(l_search=24, k=5, max_hops=80, beam_width=2,
                                mode=mode, l_valid=16, **kw)


def _clone(st):
    return tsearch.HopState(*(t.clone() for t in st))


def _ctx_fetch(store, packed, **kw):
    """``local_fetch`` behind the disk tier's ``wants_ctx`` contract (the
    ids are the first row of ``packed``)."""
    return tsearch.local_fetch(store, packed[0])


_ctx_fetch.wants_ctx = True


def _custom_distance(codes, table):
    return tops.pq_scan(codes.contiguous(), table)


CASES = {
    "clean": ({}, {}),
    "wants_ctx_fetch": ({"fetch_fn": _ctx_fetch}, {}),
    "wants_ctx_fetch_post": ({"fetch_fn": _ctx_fetch}, {"mode": "post"}),
    "wants_ctx_fetch_strict_in": ({"fetch_fn": _ctx_fetch},
                                  {"mode": "strict_in"}),
    "custom_distance": ({"distance_fn": _custom_distance}, {}),
    "fault_plan": ({}, {"fault_plan": FaultPlan(read_fail_rate=0.1,
                                                seed=3)}),
    "store_without_graphs": ({}, {}),
}
GRAPHABLE = {"clean", "wants_ctx_fetch", "wants_ctx_fetch_post"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_path_needs_the_clean_device_hop(case):
    """``_graphable`` holds for CUDA tensors of a store that keeps hop
    graphs, with the default distance and no fault plan, and with
    ``local_fetch`` or, outside strict_in, a ``wants_ctx`` (host) fetch,
    and for nothing else: the other cases fail it on CUDA tensors (a host
    fetch in strict_in among them), and CPU tensors fail it in every
    case."""
    kw, pkw = CASES[case]
    p = _params(**pkw)
    fetch = kw.get("fetch_fn", tsearch.local_fetch)
    dist = kw.get("distance_fn")
    store = types.SimpleNamespace(
        hop_graphs=None if case == "store_without_graphs" else object())
    card = types.SimpleNamespace(is_cuda=True)
    on_card = tsearch._graphable(store, card,
                                 types.SimpleNamespace(visited=card), p,
                                 fetch, dist)
    assert on_card == (case in GRAPHABLE)
    cpu = torch.zeros(1)
    assert not tsearch._graphable(store, cpu,
                                  types.SimpleNamespace(visited=cpu), p,
                                  fetch, dist)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_hop_loop_takes_the_eager_path(small, monkeypatch, case):
    """On the CPU the pipelined driver never reaches the graph path, in any
    case, its tally counts no graphed hop step and no capture, and the
    store's graph cache stays empty."""
    ds, e, qf = small
    kw, pkw = CASES[case]
    store = e.store
    if case == "store_without_graphs":
        store = store._replace(hop_graphs=None)

    def refuse(*args, **kwargs):
        raise AssertionError("the graph path ran on the CPU")

    monkeypatch.setattr(tsearch, "_run_graphed", refuse)
    p = _params(**pkw)
    with trace.batch() as t:
        res = tsearch.filtered_search_pipelined(
            store, e.codes, e.codebook, e.mem, qf, ds.queries, e.medoid, p,
            hop_chunk=4, **kw)
    assert int(res.hops.sum()) > 0
    assert t["hop_steps"] > 0
    assert t["hop_steps_graphed"] == 0 and t["graph_captures"] == 0
    assert e.store.hop_graphs.graphs == {}
    assert e.store.hop_graphs.pool is None


@pytest.mark.parametrize("width", [8, 12])
@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_graph_body_equals_eager_loop(small, mode, width):
    """The body a hop graph captures (``_HopGraph.step``: the fetch, then
    the hop step copied over the static state), stepped eagerly on its
    static buffers over two loads, equals ``_run_hops_eager`` on every
    ``HopState`` field bit for bit; ``unload`` updates the chunk's own
    ``visited`` in place and returns no static buffer."""
    ds, e, qf = small
    p = _params(mode)
    idx = np.arange(width) % ds.queries.shape[0]
    ctx, st = tsearch.init_search(
        e.store, e.codes, e.codebook, e.mem,
        type(qf)(*(np.asarray(x)[idx] for x in qf)), ds.queries[idx],
        e.medoid, p)
    mc = tsearch._mc(e.mem, ctx, p, buckets=e.mem.bucket_codes.int())
    want, got = _clone(st), _clone(st)
    g = tsearch._HopGraph(e.store, e.codes, e.mem, ctx, got, mc)
    static = {t.data_ptr() for t in g.static}
    for hops in (3, 4):
        want = tsearch._run_hops_eager(e.store, e.codes, e.mem, ctx, want,
                                       hops, p)
        g.load(ctx, got, mc)
        for _ in range(hops):
            g.step(e.store, e.codes, e.mem, p)
        visited = got.visited
        got = g.unload(visited)
        assert got.visited is visited
        assert not static & {t.data_ptr() for t in got}
        for f, a, b in zip(tsearch.HopState._fields, got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f"{mode} width {width}: {f}"
    assert int(want.counters[:, 3].sum()) > 0


def _counting_fetches(ds, monkeypatch) -> list:
    """Log each ``ds.fetch`` call (the disk tier's frontier reads)."""
    calls = []
    fetch = ds.fetch

    def counted(*args, **kwargs):
        calls.append(args[0].size)
        return fetch(*args, **kwargs)

    monkeypatch.setattr(ds, "fetch", counted)
    return calls


@pytest.mark.parametrize("mode", ["post", "spec_in"])
def test_disk_graph_body_equals_eager_loop(small, disk, monkeypatch, mode):
    """The body a hop graph captures over the disk tier's stand-in store
    (``_HopGraph.step`` with the disk tier's fetch callable), stepped
    eagerly on its static buffers over two loads, equals
    ``_run_hops_eager`` with the same callable, and the device backend's
    eager loop, on every ``HopState`` field bit for bit; it reads the
    frontier once a hop, ``n_hops`` times a chunk, where the eager loop
    reads it once more."""
    ds, e, qf = small
    stub, fetch = disk.stub_store(), disk.fetch_callable
    calls = _counting_fetches(disk, monkeypatch)
    p = _params(mode)
    ctx, st = tsearch.init_search(stub, e.codes, e.codebook, e.mem, qf,
                                  ds.queries, e.medoid, p)
    mc = tsearch._mc(e.mem, ctx, p, buckets=e.mem.bucket_codes.int())
    want, got, local = _clone(st), _clone(st), _clone(st)
    g = tsearch._HopGraph(stub, e.codes, e.mem, ctx, got, mc)
    for hops in (3, 4):
        del calls[:]
        want = tsearch._run_hops_eager(stub, e.codes, e.mem, ctx, want,
                                       hops, p, fetch)
        assert len(calls) == hops + 1
        local = tsearch._run_hops_eager(e.store, e.codes, e.mem, ctx, local,
                                        hops, p)
        del calls[:]
        g.load(ctx, got, mc)
        for _ in range(hops):
            g.step(stub, e.codes, e.mem, p, fetch)
        assert calls == [ds.queries.shape[0] * p.beam_width] * hops
        got = g.unload(got.visited)
        for f, a, b, c in zip(tsearch.HopState._fields, got, want, local):
            if a.dtype == torch.float32:
                a, b, c = (t.view(torch.int32) for t in (a, b, c))
            assert torch.equal(a, b), f"{mode}: {f}"
            assert torch.equal(a, c), f"{mode} against the device: {f}"
    assert int(want.counters[:, 3].sum()) > 0


def test_tally_carries_the_graph_counters(small):
    """The tally's counters include the two graph counters, and on the CPU
    an engine call leaves both at zero while it hops."""
    ds, e, _ = small
    assert set(trace.new_tally()) == {
        "groups", "hop_steps", "row_hops_live", "row_hops_dispatched",
        "explored", "fp_explored", "hop_steps_graphed", "graph_captures",
        "host_s", "device_wait_s"}
    sels = make_selectors(ds, e, "label")
    _, _, stats = e.execute(ds.queries, sels,
                            [teng.SearchConfig(policy="post", hop_chunk=4)]
                            * len(sels))
    t = stats.trace
    assert t["hop_steps"] > 0
    assert t["hop_steps_graphed"] == 0 and t["graph_captures"] == 0


def test_entry_calls_kops_unless_this_thread_captures(monkeypatch):
    """``_entry`` calls the ``kops`` entry of its name (looked up at the
    call, so a wrapper put there is seen); while this thread captures a
    hop it hands the call to the capturing graph's ``hole`` instead, and
    another thread still calls the entry."""
    calls = []
    monkeypatch.setattr(tops, "or_scatter_",
                        lambda *a: calls.append(("kops", a)) or a[0])

    class Capturing:
        def hole(self, name, args):
            calls.append(("hole", name, args))
            return "hole"

    assert tsearch._entry("or_scatter_", "w", "i", None) == "w"
    tsearch._capture.graph = Capturing()
    try:
        assert tsearch._entry("or_scatter_", "w", "i", 7) == "hole"
        other = threading.Thread(target=tsearch._entry,
                                 args=("or_scatter_", "x", "j", None))
        other.start()
        other.join()
    finally:
        tsearch._capture.graph = None
    assert calls == [("kops", ("w", "i", None)),
                     ("hole", "or_scatter_", ("w", "i", 7)),
                     ("kops", ("x", "j", None))]


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` that logs its calls."""

    def __init__(self, log, tag):
        self.log, self.tag = log, tag

    def capture_end(self):
        self.log.append(("end", self.tag))

    def replay(self):
        self.log.append(("replay", self.tag))


def test_hole_splits_the_capture_and_replay_calls_the_entries(monkeypatch):
    """A hole ends the graph being captured, begins the next, and gives the
    fused entry's results buffers of their own (``or_scatter_`` returns its
    words, in place); a replay runs the graphs in capture order and calls
    each hole's entry between them, from ``kops`` as it stands then, with
    the arguments the capture saw, copying the fused entry's results into
    its buffers."""
    log = []
    g = tsearch._HopGraph.__new__(tsearch._HopGraph)
    g.parts = [_Graph(log, 0)]
    monkeypatch.setattr(tsearch._HopGraph, "_begin", lambda self: (
        self.parts.append(_Graph(log, len(self.parts)))))
    ids = torch.tensor([[0, 3, -1], [5, 1, 2]], dtype=torch.int32)
    args = (None, None, None, None, ids) + (None,) * 6
    key, ok = g.hole("hop_fused_gather", args)
    assert key.shape == ok.shape == ids.shape
    assert (key.dtype, ok.dtype) == (torch.float32, torch.bool)
    words = torch.zeros((2, 1), dtype=torch.int32)
    assert g.hole("or_scatter_", (words, ids, None)) is words
    assert log == [("end", 0), ("end", 2)]
    assert [type(p) for p in g.parts] == [_Graph, tuple, _Graph, tuple,
                                          _Graph]

    def fused(*a):
        log.append(("hop_fused_gather", a[4] is ids))
        return (torch.full(ids.shape, 2.5),
                torch.ones(ids.shape, dtype=torch.bool))

    monkeypatch.setattr(tops, "hop_fused_gather", fused)
    scatter = tops.or_scatter_
    monkeypatch.setattr(tops, "or_scatter_", lambda *a: (
        log.append(("or_scatter_", a[0] is words)) or scatter(*a)))
    del log[:]
    g.replay()
    assert log == [("replay", 0), ("hop_fused_gather", True), ("replay", 2),
                   ("or_scatter_", True), ("replay", 4)]
    assert torch.equal(key, torch.full(ids.shape, 2.5))
    assert bool(ok.all())
    assert words.tolist() == [[1 | 1 << 3], [1 << 5 | 1 << 1 | 1 << 2]]


def test_fetch_hole_fills_the_static_records_at_each_replay(small, disk,
                                                            monkeypatch):
    """A host fetch's hole ends the graph being captured, holds the store
    without its graph cache, and gives the records static buffers shaped
    as the store's fields; each replay runs the graph that packs the ids,
    then calls the fetch once on whatever ids the packed buffer then holds,
    filling those buffers with the disk tier's records (equal to a direct
    call), then runs the next graph."""
    _, e, _ = small
    stub, fetch = disk.stub_store(), disk.fetch_callable
    log = []
    g = tsearch._HopGraph.__new__(tsearch._HopGraph)
    g.parts = [_Graph(log, 0)]
    monkeypatch.setattr(tsearch._HopGraph, "_begin", lambda self: (
        self.parts.append(_Graph(log, len(self.parts)))))
    calls = _counting_fetches(disk, monkeypatch)
    packed = torch.tensor([[4, 9, 0, 17], [2, 2, 3, 3], [1, 1, 0, 1]],
                          dtype=torch.int32)
    out = g.hole("fetch", (fetch, stub, packed, True))
    assert log == [("end", 0)] and len(g.parts) == 3
    assert g.parts[1][1][1].hop_graphs is None
    assert stub.hop_graphs is not None
    fields = dict(tsearch._record_fields(stub))
    assert set(out) == set(fields)
    for f, t in out.items():
        assert (t.shape[1:], t.dtype) == (fields[f].shape[1:],
                                          fields[f].dtype)
        assert t.shape[0] == 4
    for ids in ([4, 9, 0, 17], [30, 31, 5, 6]):
        packed[0] = torch.tensor(ids)
        del log[:], calls[:]
        g.replay()
        assert log == [("replay", 0), ("replay", 2)]
        assert calls == [4]
        want = fetch(stub, packed, dense=True)
        for f in out:
            assert torch.equal(out[f], want[f]), f
        assert torch.equal(out["vectors"][[0, 1, 3]],
                           e.store.vectors[[ids[0], ids[1], ids[3]]])
        assert bool((out["neighbors"][2] == -1).all())   # a dead row

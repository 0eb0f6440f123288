"""The port's serving tier (``repro_torch.serve``) and its last degrade rung
(``Index.approx_scan_batch``) against ``repro``.

One small ``repro`` Index is built; the port's Index wraps the same state.
The gated full-corpus scan must return only exactly-verified records, lose
no valid one, and equal ``repro``'s per request. The threaded server is
checked only where its assertions are not races: results of an unloaded
server equal a direct search, a pinned scan rung serves verified results,
a full queue rejects with a retry hint, an infeasible deadline is shed at
admission, and ``warmup`` runs every rung (the scan path included). Every
wait on a handle or a thread carries its own timeout.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro import api as japi
from repro.core import cost_model as jcost
from repro_torch import api as tapi
from repro_torch.api.session import PendingSearch
from repro_torch.core import cost_model, prefilter
from repro_torch.core.engine import apply_rung, scan_rerank
from repro_torch.serve import (RetrievalFrontend, SearchServer,
                               ServerConfig)
from torch_port_helpers import port_index

N = 900
N_CAT = 12
D = 24
WAIT_S = 120


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    vectors = rng.normal(0, 1, (N, D)).astype(np.float32)
    cats = [sorted(set(int(x) for x in
                       rng.integers(0, N_CAT, rng.integers(1, 4))))
            for _ in range(N)]
    values = rng.uniform(0, 100, N).astype(np.float32)
    metadata = [{"cat": c, "value": float(v)}
                for c, v in zip(cats, values)]
    return vectors, metadata, cats, values


@pytest.fixture(scope="module")
def jindex(corpus):
    vectors, metadata, *_ = corpus
    return japi.Index.build(
        vectors, metadata,
        japi.IndexConfig(r=12, r_dense=64, l_build=24, pq_m=8),
        defaults=japi.SearchConfig(k=10, l=32, max_hops=128))


@pytest.fixture(scope="module")
def index(jindex):
    return port_index(jindex)


def make_requests(corpus, n=8, seed=3, api=tapi, **kw):
    vectors, _, cats, _ = corpus
    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, N, n)
    return [api.SearchRequest(query=vectors[i],
                              filter=api.Tag("cat") == cats[i][0], **kw)
            for i in idxs]


def brute_valid(corpus, cat):
    return {i for i, c in enumerate(corpus[2]) if cat in c}


# ---------------------------------------------------------------------------
# The degrade ladder's cost model
# ---------------------------------------------------------------------------

def test_ladder_costs_match_repro(index, jindex):
    for cat in (0, 3, 7):
        sel_t = index.compile_filter(tapi.Tag("cat") == cat)
        sel_j = jindex.compile_filter(japi.Tag("cat") == cat)
        cfg = index.config
        ci_t = index.engine.cost_inputs(sel_t.plan(cfg.ql, cfg.cap, cfg.qr),
                                        index.defaults)
        ci_j = jindex.engine.cost_inputs(
            sel_j.plan(cfg.ql, cfg.cap, cfg.qr), jindex.defaults)
        for eff in (True, False):
            got = cost_model.ladder_costs(ci_t, effective=eff)
            want = jcost.ladder_costs(ci_j, effective=eff)
            assert [(r.name, c) for r, c in got] == \
                [(r.name, c) for r, c in want]
        for rung in cost_model.DEGRADE_LADDER:
            assert index.engine.estimate_cost(sel_t, index.defaults, rung) \
                == jindex.engine.estimate_cost(
                    sel_j, jindex.defaults,
                    jcost.DEGRADE_LADDER[cost_model.DEGRADE_LADDER.index(
                        rung)])


# ---------------------------------------------------------------------------
# Approximate full-scan rung: no false negatives, no false positives
# ---------------------------------------------------------------------------

def test_approx_scan_no_false_positives(index, jindex, corpus):
    reqs = make_requests(corpus, n=6, k=10)
    got = index.approx_scan_batch(reqs)
    want = jindex.approx_scan_batch(make_requests(corpus, n=6, k=10,
                                                  api=japi))
    for req, res, ref in zip(reqs, got, want):
        valid = brute_valid(corpus, req.filter.value)
        for i, _, m in res.matches:
            assert i in valid
            assert m is not None
        np.testing.assert_array_equal(res.ids, ref.ids)
        np.testing.assert_allclose(res.dists, ref.dists, rtol=1e-6,
                                   atol=1e-6)


def test_approx_scan_no_false_negatives_exhaustive(index, jindex, corpus):
    """A filter with ≤ rerank valid records: the gated scan returns the
    exact valid top-k (the gate only over-admits, the verifier restores
    exactness), as ``repro`` does."""
    vectors, _, _, values = corpus
    vs = np.sort(values)
    lo, hi = float(vs[0]), float(vs[14])     # 15 valid records « rerank
    valid = [i for i, v in enumerate(values) if lo <= v <= hi]
    assert len(valid) <= scan_rerank(index.defaults)
    q = vectors[5]
    exact = sorted(valid, key=lambda i: float(
        np.sum((vectors[i] - q) ** 2)))[:index.defaults.k]
    res = index.approx_scan_batch([tapi.SearchRequest(
        query=q, filter=tapi.Num("value").between(lo, hi))])[0]
    assert [i for i, _, _ in res.matches] == exact
    ref = jindex.approx_scan_batch([japi.SearchRequest(
        query=q, filter=japi.Num("value").between(lo, hi))])[0]
    np.testing.assert_array_equal(res.ids, ref.ids)


def test_scan_all_gated_pads_and_ties():
    """Fewer rows than the re-rank budget pad with (-1, BIG) after the
    rows; rows the gate rejects all carry the same penalised key and keep
    id order behind every admitted row."""
    import torch
    from repro_torch.core.selectors import InMemory, filter_to_device, \
        stack_filters, always_true_filter
    rng = np.random.default_rng(0)
    n, m, k = 6, 4, 16
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    cents = torch.from_numpy(rng.normal(0, 1, (m, k, 2)).astype(np.float32))
    from repro_torch.core.pq import PQCodebook
    cb = PQCodebook(centroids=cents, dim=2 * m)
    qf = always_true_filter(8, 16)
    qf = qf._replace(bucket_lo=np.full(4, 1, np.int32),
                     bucket_hi=np.full(4, 1, np.int32),
                     range_field=np.array([0, -1, -1, -1], np.int32))
    mem = InMemory(blooms=torch.zeros(n, dtype=torch.int32),
                   bucket_codes=torch.tensor([[1], [0], [1], [0], [0], [0]],
                                             dtype=torch.uint8))
    ids, keys = prefilter.scan_all_gated(
        codes, cb, mem, filter_to_device(stack_filters([qf]), "cpu"),
        torch.zeros(2 * m), 9)
    ids = ids.tolist()
    assert sorted(ids[:2]) == [0, 2]                  # admitted rows first
    assert ids[2:6] == [1, 3, 4, 5]                   # penalised, by id
    assert ids[6:] == [-1, -1, -1]
    assert (keys[2:6] >= prefilter.INVALID_PENALTY).all()
    assert (keys[6:] == prefilter.BIG).all()


def test_scan_rung_server_serves_verified_results(index, corpus):
    """A server pinned to the scan rung (singleton ladder) still returns
    only exactly-verified matches."""
    reqs = make_requests(corpus, n=5, seed=9, k=10)
    ladder = (cost_model.DEGRADE_LADDER[-1],)
    with SearchServer(index, ServerConfig(max_batch=8, max_delay_s=0.001),
                      ladder=ladder) as srv:
        handles = [srv.submit(r) for r in reqs]
        for req, h in zip(reqs, handles):
            res = h.result(timeout=WAIT_S)
            assert h.rung == "scan"
            assert res.stats.mechanism == "scan"
            valid = brute_valid(corpus, req.filter.value)
            for i, _, _ in res.matches:
                assert i in valid
        assert srv.stats().degraded_served >= len(reqs)


# ---------------------------------------------------------------------------
# The server at zero pressure, and deadline_us on the search path
# ---------------------------------------------------------------------------

def test_deadline_none_bit_identical(index, corpus):
    reqs = make_requests(corpus, n=8, seed=5, k=10)
    base = index.search_batch(reqs)
    again = index.search_batch([dataclasses.replace(r, deadline_us=None)
                                for r in reqs])
    for a, b in zip(base, again):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists, b.dists)
    with_dl = dataclasses.replace(reqs[0], deadline_us=5e6)
    assert "deadline_us" not in with_dl.overrides()
    assert index._resolve_scfg(with_dl) == index._resolve_scfg(reqs[0])


def test_server_unloaded_bit_identical_to_direct(index, jindex, corpus):
    """At zero pressure the server runs the full rung: its results are
    bitwise a direct batched search's, whose ids are ``repro``'s."""
    reqs = make_requests(corpus, n=8, seed=7, k=10)
    direct = index.search_batch(reqs)
    ref = jindex.search_batch(make_requests(corpus, n=8, seed=7, k=10,
                                            api=japi))
    with SearchServer(index, ServerConfig(max_batch=8,
                                          max_delay_s=0.05)) as srv:
        handles = [srv.submit(r) for r in reqs]
        served = [h.result(timeout=WAIT_S) for h in handles]
    for h in handles:
        assert h.rung == "full"
    for a, b, c in zip(direct, served, ref):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists, b.dists)
        assert np.array_equal(a.ids, c.ids)


# ---------------------------------------------------------------------------
# Admission: backpressure + shedding
# ---------------------------------------------------------------------------

def test_overloaded_carries_retry_after(index, corpus):
    reqs = make_requests(corpus, n=4, seed=13)
    # a long batching window holds the worker while the tiny queue fills
    with SearchServer(index, ServerConfig(max_queue=2, max_batch=64,
                                          max_delay_s=5.0)) as srv:
        h = [srv.submit(reqs[0]), srv.submit(reqs[1])]
        with pytest.raises(tapi.Overloaded) as ei:
            srv.submit(reqs[2])
        assert ei.value.retry_after_s > 0
        assert srv.stats().rejected_overload == 1
    # stop() drained the queue: both admitted requests resolved
    assert all(x.done for x in h)


def test_infeasible_deadline_shed_at_admission(index, corpus):
    req = make_requests(corpus, n=1, seed=17)[0]
    with SearchServer(index, ServerConfig()) as srv:
        with pytest.raises(tapi.DeadlineExceeded):
            srv.submit(dataclasses.replace(req, deadline_us=1e-3))
        st = srv.stats()
        assert st.shed_deadline == 1 and st.admitted == 0


def test_deadline_expires_in_queue_sheds_handle(index, corpus):
    req = make_requests(corpus, n=1, seed=19)[0]
    cfg = ServerConfig(max_batch=64, max_delay_s=0.25,
                       seed_us_per_cost=1e-3)
    with SearchServer(index, cfg) as srv:
        h = srv.submit(dataclasses.replace(req, deadline_us=2e3))
        with pytest.raises(tapi.DeadlineExceeded):
            h.result(timeout=WAIT_S)
        assert srv.stats().shed_deadline == 1


def test_stats_probe_shape(index, corpus):
    with SearchServer(index, ServerConfig()) as srv:
        st = srv.stats()
        assert st.healthy and st.ready and not st.warmed
        assert st.queue_depth == 0 and st.in_flight == 0 and st.shards == 1
        srv.submit(make_requests(corpus, n=1)[0]).result(timeout=WAIT_S)
        st = srv.stats()
        assert st.completed == 1 and st.p50_us > 0 and st.p99_us > 0
    assert not srv.stats().ready     # stopped servers fail readiness
    with pytest.raises(tapi.ServeError, match="stopped"):
        srv.submit(make_requests(corpus, n=1)[0])


def test_calibrate_service_model(index, corpus):
    with SearchServer(index, ServerConfig()) as srv:
        overhead, slope = srv.calibrate_service_model(
            make_requests(corpus, n=8))
        assert slope > 0 and overhead >= 0
        st = srv.stats()
        assert st.us_per_cost == pytest.approx(slope)
        assert st.overhead_us == pytest.approx(overhead)
        assert srv._predict_us(1.0) > 0


def test_tail_guard_tracks_slow_flushes(index):
    with SearchServer(index, ServerConfig()) as srv:
        with srv._lock:
            for c in (10.0, 20.0, 30.0, 40.0):
                srv._refit_locked(c, c * 100.0)
            for c in (12.0, 22.0, 32.0, 42.0):
                srv._refit_locked(c, c * 200.0)
            guard = srv._tail_guard_us
            assert guard > 0.0
            assert srv._predict_tail_us(5.0) == pytest.approx(
                srv._predict_us(5.0) + guard)
        assert srv.stats().tail_guard_us == pytest.approx(guard)


# ---------------------------------------------------------------------------
# Thread-safe Session handles
# ---------------------------------------------------------------------------

def test_result_timeout_on_inflight_handle(index, corpus):
    sess = tapi.Session(index, tapi.SessionConfig(auto_flush=False))
    h = PendingSearch(sess, make_requests(corpus, n=1)[0])
    h._claimed = True       # another thread's flush owns it
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        h.result(timeout=0.05)
    assert time.monotonic() - t0 < 5


def test_result_waits_across_threads(index, corpus):
    sess = tapi.Session(index, tapi.SessionConfig(auto_flush=False))
    handles = sess.submit_many(make_requests(corpus, n=4, seed=23))
    got = {}

    def waiter():
        got["res"] = handles[-1].result(timeout=WAIT_S)

    t = threading.Thread(target=waiter)
    with sess._lock:
        batch, sess._pending = sess._pending, []
        for hh, _ in batch:
            hh._claimed = True
    t.start()
    sess._execute_isolated([hh for hh, _ in batch],
                           [sess.config.flush_retry_budget])
    t.join(WAIT_S)
    assert not t.is_alive() and len(got["res"]) > 0


def test_concurrent_submit_result_threads(index, corpus):
    sess = tapi.Session(index, tapi.SessionConfig(max_batch=4,
                                                  max_delay_s=0.0))
    reqs = make_requests(corpus, n=16, seed=29, k=10)
    direct = index.search_batch(reqs)
    errors = []
    results = [None] * len(reqs)

    def worker(i):
        try:
            results[i] = sess.submit(reqs[i]).result(timeout=WAIT_S)
        except Exception as e:      # noqa: BLE001 - collected for assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    for a, b in zip(direct, results):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists, b.dists)


def test_poisoned_batch_isolated_under_contention(index, corpus):
    sess = tapi.Session(index, tapi.SessionConfig(max_batch=6,
                                                  max_delay_s=0.0))
    good = make_requests(corpus, n=10, seed=31)
    bad = tapi.SearchRequest(query=np.zeros(D, np.float32),
                             filter=tapi.Tag("no_such_field") == 1)
    outcomes = [None] * 11

    def worker(i, req):
        try:
            outcomes[i] = ("ok", sess.submit(req).result(timeout=WAIT_S))
        except Exception as e:      # noqa: BLE001
            outcomes[i] = ("err", e)

    threads = [threading.Thread(target=worker, args=(i, r))
               for i, r in enumerate(good + [bad])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    kinds = [o[0] for o in outcomes]
    assert kinds[:10] == ["ok"] * 10
    assert kinds[10] == "err"
    assert isinstance(outcomes[10][1], tapi.UnknownFieldError)


# ---------------------------------------------------------------------------
# Warmup: every rung runs, the scan path included
# ---------------------------------------------------------------------------

def test_warmup_covers_degrade_rungs(index, corpus, monkeypatch):
    reqs = make_requests(corpus, n=4, seed=37)
    seen = {"search": set(), "scan": set(), "scan_calls": 0}
    search_batch, approx_scan_batch = index.search_batch, \
        index.approx_scan_batch
    scan_all_gated = prefilter.scan_all_gated

    def record(kind, fn):
        def wrapped(requests, *a, scfgs=None, **kw):
            cfgs = scfgs if scfgs is not None else [
                index._resolve_scfg(r) for r in requests]
            seen[kind].update(cfgs)
            return fn(requests, *a, scfgs=scfgs, **kw)
        return wrapped

    def counted(*a, **kw):
        seen["scan_calls"] += 1
        return scan_all_gated(*a, **kw)

    monkeypatch.setattr(index, "search_batch", record("search",
                                                      search_batch))
    monkeypatch.setattr(index, "approx_scan_batch",
                        record("scan", approx_scan_batch))
    monkeypatch.setattr(prefilter, "scan_all_gated", counted)
    sess = tapi.Session(index, tapi.SessionConfig(auto_flush=False))
    sess.warmup(reqs)
    scfgs = [index._resolve_scfg(r) for r in reqs]
    for rung in cost_model.DEGRADE_LADDER:
        rcfgs = {apply_rung(sc, rung) for sc in scfgs}
        kind = "scan" if rung.approx else "search"
        assert rcfgs <= seen[kind], rung.name
    # the scan path ran once per request of the approx rung
    assert seen["scan_calls"] == len(reqs)
    assert sess.n_requests == 0 and sess.pending == 0


# ---------------------------------------------------------------------------
# Retrieval frontend
# ---------------------------------------------------------------------------

def test_retrieval_frontend_batches_and_matches_direct(index, corpus):
    vectors, _, cats, _ = corpus
    fe = RetrievalFrontend(index, tapi.SessionConfig(max_batch=3,
                                                     max_delay_s=1e9))
    assert fe.schema == index.schema
    handles = [fe.submit(vectors[i], tapi.Tag("cat") == cats[i][0], k=5)
               for i in (1, 2)]
    assert fe.session.pending == 2
    res = fe.retrieve(vectors[3], tapi.Tag("cat") == cats[3][0], k=5)
    assert fe.session.pending == 0 and fe.session.n_batches == 1
    direct = index.search_batch([
        tapi.SearchRequest(query=vectors[i], filter=tapi.Tag("cat")
                           == cats[i][0], k=5) for i in (1, 2, 3)])
    for got, want in zip([h.result(timeout=WAIT_S) for h in handles]
                         + [res], direct):
        assert np.array_equal(got.ids, want.ids)
    docs = np.arange(N * 8).reshape(N, 8)
    ctx = RetrievalFrontend.context_tokens(res, docs, per_doc=2)
    assert ctx.shape == (2 * len(res),)

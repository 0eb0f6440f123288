"""The port's query layer (``repro_torch.api``) against ``repro.api``.

One small ``repro`` Index is built from metadata dicts; the port's Index
wraps the same state (``FilteredANNEngine.from_arrays`` on the CPU, the
same vocabulary, schema and defaults). Filter plans, ``eval_mask``,
``ground_truth`` and ``record_metadata`` must be equal; ``search_batch``
and ``approx_scan_batch`` must be equal per request — ids, mechanism and
integer counters exactly, distances ``allclose(rtol=1e-6, atol=1e-6)``.
The Session scheduler's flush and poisoned-batch contracts are checked on
the port's Index against ``repro``'s results.
"""
import numpy as np
import pytest

from repro import api as japi
from repro.api.filters import eval_mask as j_eval_mask
from repro_torch import api as tapi
from repro_torch.api.filters import eval_mask as t_eval_mask
from torch_port_helpers import port_index

N = 2000
N_CAT = 14
LANGS = ["en", "de", "fr", "ja"]
D = 24
INT_STATS = ("io_pages", "dist_comps", "hops", "explored", "fp_explored",
             "n_valid", "faults", "retries", "degraded")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    vectors = rng.normal(0, 1, (N, D)).astype(np.float32)
    cats = [sorted(set(int(x) for x in
                       rng.integers(0, N_CAT, rng.integers(1, 4))))
            for _ in range(N)]
    langs = [str(rng.choice(LANGS)) for _ in range(N)]
    values = rng.uniform(0, 100, N).astype(np.float32)
    metadata = [{"cat": c, "lang": l, "value": float(v)}
                for c, l, v in zip(cats, langs, values)]
    return vectors, metadata, values


@pytest.fixture(scope="module")
def jindex(corpus):
    vectors, metadata, _ = corpus
    return japi.Index.build(
        vectors, metadata, japi.IndexConfig(r=12, r_dense=80, l_build=24,
                                            pq_m=8),
        defaults=japi.SearchConfig(k=10, l=32, max_hops=250))


@pytest.fixture(scope="module")
def tindex(jindex):
    return port_index(jindex)


def exprs(api, values) -> dict:
    """The same filter expressions in either package's DSL."""
    Tag, Num = api.Tag, api.Num
    vs = np.sort(values)
    x = float(values[42])
    return {
        "label": Tag("cat") == 3,
        "label_or": Tag("cat").isin([1, 2, 5]),
        "label_and": (Tag("cat") == 1) & (Tag("cat") == 2),
        "range": Num("value").between(10, 50),
        "hybrid": (Tag("cat") == 3) & Num("value").between(10, 50),
        "hybrid_or": (Tag("cat") == 3) | Num("value").between(10, 50),
        "multi_field": ((Tag("lang") == "en") & (Num("value") >= 20)
                        & (Num("value") < 60)),
        "mask_or_of_and": (((Tag("cat") == 1) & (Tag("lang") == "en"))
                           | ((Tag("cat") == 2) & (Tag("lang") == "de"))),
        "mask_disjoint": (Num("value").between(0, 10)
                          | Num("value").between(60, 70)),
        # three valid records of 2000
        "near_empty": Num("value").between(float(vs[0]), float(vs[3])),
        "unknown_tag": Tag("cat") == 999,
        "point": Num("value") == x,
        "le": Num("value") <= x,
        "gt": Num("value") > x,
    }


def _assert_plans_equal(pj, pt, name):
    for f, a in pj.qfilter._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(pt.qfilter, f)),
                                      np.asarray(a), err_msg=f"{name}: {f}")
    for f in ("selectivity", "precision_in", "precision_pre",
              "pages_prefetch", "pages_prescan", "force_mech"):
        assert getattr(pt, f) == getattr(pj, f), (name, f)


def test_compile_expr_plans_equal(jindex, tindex, corpus):
    """Every expression compiles to the same selector kind and plan."""
    values = corpus[2]
    cfg = jindex.config
    je, te = exprs(japi, values), exprs(tapi, values)
    for name in je:
        sj = japi.compile_expr(je[name], jindex)
        st = tapi.compile_expr(te[name], tindex)
        assert type(st).__name__ == type(sj).__name__, name
        _assert_plans_equal(sj.plan(cfg.ql, cfg.cap, cfg.qr),
                            st.plan(cfg.ql, cfg.cap, cfg.qr), name)


def test_eval_mask_equal(jindex, tindex, corpus):
    values = corpus[2]
    je, te = exprs(japi, values), exprs(tapi, values)
    for name in je:
        mj, pj = j_eval_mask(je[name], jindex)
        mt, pt = t_eval_mask(te[name], tindex)
        np.testing.assert_array_equal(mt, mj, err_msg=name)
        assert pt == pj, name


def test_compile_rejects_unknown_field_and_handle(tindex):
    with pytest.raises(tapi.UnknownFieldError, match="not indexed"):
        tapi.compile_expr(tapi.Num("nope") < 5.0, tindex)
    with pytest.raises(ValueError, match="not indexed"):
        tindex.ground_truth(tapi.SearchRequest(
            query=np.zeros(D, np.float32), filter=tapi.Num("nope") < 5.0))
    with pytest.raises(TypeError, match="field handle"):
        tapi.compile_expr(tapi.Tag("cat"), tindex)


def test_ground_truth_and_metadata_equal(jindex, tindex, corpus):
    vectors, metadata, values = corpus
    je, te = exprs(japi, values), exprs(tapi, values)
    rng = np.random.default_rng(3)
    qs = rng.normal(0, 1, (3, D)).astype(np.float32)
    for name in [None, *je]:
        for q in qs:
            gj = jindex.ground_truth(japi.SearchRequest(
                query=q, filter=None if name is None else je[name]))
            gt = tindex.ground_truth(tapi.SearchRequest(
                query=q, filter=None if name is None else te[name]))
            np.testing.assert_array_equal(gt, gj, err_msg=str(name))
    for i in (0, 5, 42, 1000, N - 1):
        assert tindex.record_metadata(i) == jindex.record_metadata(i)
        assert tindex.record_metadata(i)["lang"] == metadata[i]["lang"]


def _requests(api, values, names, seed, **kw):
    rng = np.random.default_rng(seed)
    ex = exprs(api, values)
    out = []
    for name in names:
        q = rng.normal(0, 1, D).astype(np.float32)
        out.append(api.SearchRequest(
            query=q, filter=None if name is None else ex[name], **kw))
    return out


def _assert_results_equal(rj, rt, sj, st, names):
    assert st.mechanism == sj.mechanism
    for f in INT_STATS:
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f),
                                      err_msg=f)
    for i, (a, b) in enumerate(zip(rj, rt)):
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=str(names[i]))
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-6, atol=1e-6)
        assert b.stats.mechanism == a.stats.mechanism
        assert b.metadata == a.metadata


WORKLOADS = {
    "label": ["label", "label_or", "label_and", "unknown_tag"],
    "range": ["range", "near_empty", "point", "le", "gt"],
    "hybrid": ["hybrid", "hybrid_or", "multi_field", "mask_or_of_and",
               "mask_disjoint"],
    "none": [None, None, "label"],
}


@pytest.mark.parametrize("policy", ["speculative", "post", "strict_pre"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_search_batch_matches_repro(jindex, tindex, corpus, workload,
                                    policy):
    values = corpus[2]
    names = WORKLOADS[workload] * 2
    rj, sj = jindex.search_batch(
        _requests(japi, values, names, 11, policy=policy), with_stats=True)
    rt, st = tindex.search_batch(
        _requests(tapi, values, names, 11, policy=policy), with_stats=True)
    _assert_results_equal(rj, rt, sj, st, names)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_approx_scan_batch_matches_repro(jindex, tindex, corpus, workload):
    values = corpus[2]
    names = WORKLOADS[workload]
    rj, sj = jindex.approx_scan_batch(_requests(japi, values, names, 13),
                                      with_stats=True)
    rt, st = tindex.approx_scan_batch(_requests(tapi, values, names, 13),
                                      with_stats=True)
    _assert_results_equal(rj, rt, sj, st, names)
    assert st.mechanism == ["scan"] * len(names)
    assert (st.degraded == 1).all()
    np.testing.assert_array_equal(st.est_io_pages, sj.est_io_pages)
    np.testing.assert_array_equal(st.est_compute, sj.est_compute)


def test_per_request_overrides_and_empty_batch(jindex, tindex, corpus):
    values = corpus[2]
    names = ["label", "label", "label"]
    over = [dict(k=3), dict(k=7, l=64), dict(policy="post")]
    rj = jindex.search_batch([
        japi.SearchRequest(query=r.query, filter=r.filter, **o) for r, o in
        zip(_requests(japi, values, names, 17), over)])
    rt = tindex.search_batch([
        tapi.SearchRequest(query=r.query, filter=r.filter, **o) for r, o in
        zip(_requests(tapi, values, names, 17), over)])
    assert [r.ids.shape for r in rt] == [(3,), (7,), (10,)]
    assert rt[2].stats.mechanism == "post"
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.ids, a.ids)
    assert tindex.search_batch([]) == []
    results, stats = tindex.approx_scan_batch([], with_stats=True)
    assert results == [] and stats.mechanism == []


def test_index_build_from_metadata_on_cpu(corpus):
    """``Index.build`` ingests metadata dicts as ``repro`` does: the same
    schema, vocabulary, label arrays and value matrix; its search returns
    only exactly-valid records."""
    vectors, metadata, _ = corpus
    n = 300
    cfg = dict(r=8, r_dense=32, l_build=16, pq_m=4)
    ji = japi.Index.build(vectors[:n], metadata[:n], japi.IndexConfig(**cfg))
    ti = tapi.Index.build(vectors[:n], metadata[:n], tapi.IndexConfig(**cfg),
                          device="cpu")
    assert ti.schema.tags == ji.schema.tags == ("cat", "lang")
    assert ti.schema.nums == ji.schema.nums == ("value",)
    assert ti.vocab == ji.vocab
    np.testing.assert_array_equal(ti.label_store.vec_offsets,
                                  ji.label_store.vec_offsets)
    np.testing.assert_array_equal(ti.label_store.vec_labels,
                                  ji.label_store.vec_labels)
    np.testing.assert_array_equal(ti.range_store.values,
                                  ji.range_store.values)
    expr = (tapi.Tag("lang") == "en") & tapi.Num("value").between(20, 80)
    res = ti.search(tapi.SearchRequest(query=vectors[3], filter=expr))
    assert len(res) > 0
    for rec_id, _, meta in res.matches:
        assert metadata[rec_id]["lang"] == "en" == meta["lang"]
        assert 20 <= metadata[rec_id]["value"] < 80


def test_build_numeric_field_matches_repro(corpus, tmp_path):
    """The deprecated single-field spelling ``Index.build(vectors, metadata,
    config, None, "v")``: both packages pin the schema to ``nums=("v",)``
    with every other key a tag field, answer ``numeric_field`` with "v",
    compile the same plans and ground truth, and refuse it beside
    ``schema=``; the port's search over ``repro``'s graph answers as
    ``repro``; a port index saved to disk loads in ``repro`` with its
    ``numeric_field``."""
    vectors, metadata, _ = corpus
    n = 300
    meta = [{"cat": m["cat"], "lang": m["lang"], "v": m["value"]}
            for m in metadata[:n]]
    vecs = vectors[:n]
    cfg = dict(r=8, r_dense=32, l_build=16, pq_m=4)
    ji = japi.Index.build(vecs, meta, japi.IndexConfig(**cfg), None, "v")
    ti = tapi.Index.build(vecs, meta, tapi.IndexConfig(**cfg), None, "v",
                          device="cpu")
    assert ti.schema.tags == ji.schema.tags == ("cat", "lang")
    assert ti.schema.nums == ji.schema.nums == ("v",)
    assert ti.numeric_field == ji.numeric_field == "v"
    assert ti.vocab == ji.vocab
    # an inferred schema names "v" too, but the legacy branch infers nothing
    # (an int-valued "v" stays numeric)
    ints = [dict(m, v=int(m["v"])) for m in meta[:20]]
    assert tapi.Index.build(vecs[:20], ints, tapi.IndexConfig(**cfg), None,
                            "v", device="cpu").schema.nums == ("v",)
    with pytest.raises(ValueError, match="not both"):
        tapi.Index.build(vecs, meta, tapi.IndexConfig(**cfg),
                         tapi.Schema(tags=("cat", "lang"), nums=("v",)),
                         "v", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        japi.Index.build(vecs, meta, japi.IndexConfig(**cfg),
                         japi.Schema(tags=("cat", "lang"), nums=("v",)), "v")

    exprs_v = {
        "label": lambda api: api.Tag("cat") == 3,
        "range": lambda api: api.Num("v").between(10, 50),
        "hybrid": lambda api: ((api.Tag("lang") == "en")
                               & (api.Num("v") >= 20)),
    }
    c = ji.config
    rng = np.random.default_rng(9)
    qs = rng.normal(0, 1, (4, D)).astype(np.float32)
    for name, ex in exprs_v.items():
        _assert_plans_equal(
            japi.compile_expr(ex(japi), ji).plan(c.ql, c.cap, c.qr),
            tapi.compile_expr(ex(tapi), ti).plan(c.ql, c.cap, c.qr), name)
        for q in qs:
            np.testing.assert_array_equal(
                ti.ground_truth(tapi.SearchRequest(query=q, filter=ex(tapi))),
                ji.ground_truth(japi.SearchRequest(query=q, filter=ex(japi))),
                err_msg=name)
    # per query ids: the port over repro's graph, as repro
    tp = port_index(ji)
    assert tp.numeric_field == "v"
    names = list(exprs_v) * 2
    rj, sj = ji.search_batch([japi.SearchRequest(query=q, filter=exprs_v[m](
        japi)) for q, m in zip(np.repeat(qs, 2, 0)[:6], names)],
        with_stats=True)
    rt, st = tp.search_batch([tapi.SearchRequest(query=q, filter=exprs_v[m](
        tapi)) for q, m in zip(np.repeat(qs, 2, 0)[:6], names)],
        with_stats=True)
    _assert_results_equal(rj, rt, sj, st, names)
    # the port's own graph answers only valid records
    for r in ti.search_batch([tapi.SearchRequest(
            query=q, filter=exprs_v["hybrid"](tapi)) for q in qs]):
        for i in r.ids[r.ids >= 0]:
            assert meta[i]["lang"] == "en" and meta[i]["v"] >= 20

    ti.save(str(tmp_path / "idx"))
    loaded = japi.Index.load(str(tmp_path / "idx"))
    assert loaded.numeric_field == "v"
    assert loaded.schema.nums == ("v",) and len(loaded) == n


def test_build_rejects_bad_metadata():
    vecs = np.zeros((3, 8), np.float32)
    with pytest.raises(ValueError, match="missing the numeric field"):
        tapi.Index.build(vecs, [{"v": 1.0}, {"cat": 2}, {"v": 3.0}],
                         device="cpu")
    with pytest.raises(ValueError, match="vectors but"):
        tapi.Index.build(vecs, [{"v": 1.0}], device="cpu")
    with pytest.raises(ValueError, match="both float and tag"):
        tapi.Schema.infer([{"a": 1.5}, {"a": "x"}])


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

def _session_requests(api, n, seed=0):
    rng = np.random.default_rng(seed)
    qs = rng.normal(0, 1, (n, D)).astype(np.float32)
    return [api.SearchRequest(query=qs[i],
                              filter=api.Tag("cat") == int(
                                  rng.integers(0, N_CAT)), k=4)
            for i in range(n)]


def test_session_flushes_match_repro(jindex, tindex):
    """Flush on batch size, on demand and at context exit; every handle
    resolves to ``repro``'s direct result."""
    direct = jindex.search_batch(_session_requests(japi, 4))
    s = tapi.Session(tindex, tapi.SessionConfig(max_batch=4,
                                                max_delay_s=1e9))
    handles = [s.submit(r) for r in _session_requests(tapi, 4)]
    assert s.pending == 0 and s.n_batches == 1
    assert all(h.done for h in handles)
    for h, want in zip(handles, direct):
        np.testing.assert_array_equal(h.result().ids, want.ids)

    s = tapi.Session(tindex, tapi.SessionConfig(max_batch=100,
                                                max_delay_s=1e9))
    handles = s.submit_many(_session_requests(tapi, 3, seed=1))
    assert s.pending == 3 and not handles[0].done
    assert handles[0].result().ids.shape == (4,)        # demand -> flush
    assert s.pending == 0 and all(h.done for h in handles)

    with tapi.Session(tindex, tapi.SessionConfig(max_batch=100,
                                                 max_delay_s=1e9)) as s:
        handles = s.submit_many(_session_requests(tapi, 2, seed=4))
    assert all(h.done for h in handles) and s.n_flushed == 2


def test_session_poisoned_batch_isolated(tindex):
    s = tapi.Session(tindex, tapi.SessionConfig(max_batch=100,
                                                max_delay_s=1e9))
    good = s.submit_many(_session_requests(tapi, 2, seed=6))
    bad = s.submit(tapi.SearchRequest(query=np.zeros(D, np.float32),
                                      filter=tapi.Tag("cat")))
    assert s.flush() == 3
    for h in good:
        assert h.result().ids.shape == (4,)
    with pytest.raises(TypeError, match="field handle"):
        bad.result()
    h2 = s.submit(_session_requests(tapi, 1, seed=8)[0])
    s.flush()
    assert h2.result().ids.shape == (4,)


def test_session_failed_batch_fails_every_handle_legacy(tindex):
    s = tapi.Session(tindex, tapi.SessionConfig(
        max_batch=100, max_delay_s=1e9, isolate_failures=False))
    good = s.submit_many(_session_requests(tapi, 2, seed=6))
    bad = s.submit(tapi.SearchRequest(query=np.zeros(D, np.float32),
                                      filter=tapi.Tag("cat")))
    with pytest.raises(TypeError, match="field handle"):
        s.flush()
    for h in (*good, bad):
        assert h.done
        with pytest.raises(TypeError, match="field handle"):
            h.result()


def test_session_flush_retry_budget_exhaustion(tindex):
    s = tapi.Session(tindex, tapi.SessionConfig(
        max_batch=100, max_delay_s=1e9, flush_retry_budget=1))
    handles = s.submit_many(_session_requests(tapi, 2, seed=6))
    s.submit(tapi.SearchRequest(query=np.zeros(D, np.float32),
                                filter=tapi.Tag("cat")))
    s.flush()
    for h in handles:
        with pytest.raises(RuntimeError, match="retry budget exhausted"):
            h.result()


def test_pending_result_never_resolved_raises(tindex):
    s = tapi.Session(tindex, tapi.SessionConfig(max_batch=100,
                                                max_delay_s=1e9,
                                                auto_flush=False))
    h = s.submit(_session_requests(tapi, 1, seed=10)[0])
    s._pending.clear()                   # a lost request
    with pytest.raises(RuntimeError, match="never resolved"):
        h.result()

"""Search parity of the PyTorch port against the JAX package.

Both packages search the same graph, codebook and attributes (the
``shared_engine`` of tests/conftest.py, handed to the port as numpy through
``FilteredANNEngine.from_arrays``). Per query, ids and every integer counter
must be equal and distances ``allclose(rtol=1e-6, atol=1e-6)``; the port's
pipelined driver must equal its own single-shot search bit for bit; and the
engine's routed ``search`` must agree on mechanisms, ids and QueryStats.
The engine-level tests live in this one file so that ``--dist loadfile``
builds the shared engine once for them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as eng
from repro.core import search as search_mod
from repro.core.selectors import stack_filters
from repro.data.synth import make_selectors, make_sliding_range_selectors
from repro_torch.core import engine as teng
from repro_torch.core import search as tsearch
from repro_torch.core.selectors import stack_filters as t_stack_filters
from repro_torch.data.synth import make_selectors as t_make_selectors
from repro_torch.data.synth import \
    make_sliding_range_selectors as t_make_sliding
from torch_port_helpers import port_engine

SELECTIVITIES = (0.05, 0.30, 0.80)
INT_FIELDS = ("ids", "io_pages", "hops", "dist_comps", "approx_checks",
              "n_valid", "fp_explored", "explored", "faults", "retries",
              "degraded")


@pytest.fixture(scope="module")
def port(shared_ds, shared_engine):
    return port_engine(shared_engine, shared_ds)


def _params(mode, w):
    kw = dict(l_search=48, k=10, max_hops=200, l_valid=32, beam_width=w,
              mode=mode)
    return search_mod.SearchParams(**kw), tsearch.SearchParams(**kw)


def _entries(e, sels, mode):
    if mode != "strict_in":
        return None
    ents = np.full((len(sels), 4), -1, np.int32)
    for j, s in enumerate(sels):
        seeds, _ = eng._strict_seed_ids(s, e.medoid, 4)
        ents[j, :seeds.size] = seeds
    return ents


def _run_pair(ds, e, pe, mode, selectivity, w):
    nq = ds.queries.shape[0]
    sels = make_sliding_range_selectors(e, selectivity, nq)
    tsels = t_make_sliding(pe, selectivity, nq)
    qf = stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                        for s in sels])
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in tsels])
    p_jax, p_torch = _params(mode, w)
    entries = _entries(e, sels, mode)
    want = search_mod.filtered_search_pipelined(
        e.store, e.codes, e.codebook, e.mem, qf, jnp.asarray(ds.queries),
        e.medoid, p_jax,
        entries=None if entries is None else jnp.asarray(entries))
    got = tsearch.filtered_search_pipelined(
        pe.store, pe.codes, pe.codebook, pe.mem, tqf, ds.queries, pe.medoid,
        p_torch, entries=entries)
    return want, got


def _assert_same(want, got, tag):
    for f in INT_FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        bad = np.flatnonzero((w != g).reshape(w.shape[0], -1).any(1))
        assert bad.size == 0, (
            f"{tag}: {f} differs first at query {bad[0]}: "
            f"repro={w[bad[0]]} port={g[bad[0]]}")
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-6, atol=1e-6, err_msg=tag)


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
@pytest.mark.parametrize("selectivity", SELECTIVITIES)
def test_pipelined_matches_repro_w1(shared_ds, shared_engine, port, mode,
                                   selectivity):
    """W=1: the candidate slab's first-occurrence mask comes from the
    record (``cand_first``)."""
    want, got = _run_pair(shared_ds, shared_engine, port, mode, selectivity,
                          1)
    _assert_same(want, got, f"{mode}@{selectivity} W=1")


@pytest.mark.parametrize("mode", ["post", "spec_in"])
def test_pipelined_matches_repro_w2(shared_ds, shared_engine, port, mode):
    """W=2: first occurrence computed per hop (``_first_occurrence``)."""
    want, got = _run_pair(shared_ds, shared_engine, port, mode, 0.30, 2)
    _assert_same(want, got, f"{mode}@0.30 W=2")


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_pipelined_matches_single_shot(shared_ds, port, mode):
    """Compaction parity inside the port: small chunks and buckets force
    several compaction generations; every field bit-identical."""
    ds, pe = shared_ds, port
    nq = ds.queries.shape[0]
    sels = t_make_sliding(pe, 0.30, nq)
    qf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                          for s in sels])
    _, params = _params(mode, 1)
    ents = None
    if mode == "strict_in":
        ents = np.full((nq, 4), -1, np.int32)
        for j, s in enumerate(sels):
            seeds, _ = teng._strict_seed_ids(s, pe.medoid, 4)
            ents[j, :seeds.size] = seeds
    args = (pe.store, pe.codes, pe.codebook, pe.mem, qf, ds.queries,
            pe.medoid, params)
    single = tsearch.filtered_search(*args, entries=ents)
    for async_readback in (True, False):
        pipe = tsearch.filtered_search_pipelined(
            *args, entries=ents, hop_chunk=8, min_bucket=2,
            async_readback=async_readback)
        for f in tsearch.SearchResult._fields:
            assert torch.equal(getattr(pipe, f), getattr(single, f)), \
                f"{mode} async={async_readback}: {f}"


@pytest.mark.parametrize("mode", ["post", "spec_in"])
def test_in_place_visited_repeatable_and_consumed(shared_ds, shared_engine,
                                                  port, mode):
    """The hop updates the visited words in place: the compacting search
    with the async readback, run twice on one batch, answers the same each
    time, as the single-shot search and as ``repro``; ``run_hops`` consumes
    the state it is given (the returned state holds its visited tensor,
    changed), and a clone taken before resumes exactly as it did."""
    ds, e, pe = shared_ds, shared_engine, port
    nq = ds.queries.shape[0]
    sels = make_sliding_range_selectors(e, 0.30, nq)
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in t_make_sliding(pe, 0.30, nq)])
    p_jax, params = _params(mode, 1)
    want = search_mod.filtered_search_pipelined(
        e.store, e.codes, e.codebook, e.mem,
        stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                       for s in sels]), jnp.asarray(ds.queries), e.medoid,
        p_jax)
    args = (pe.store, pe.codes, pe.codebook, pe.mem, tqf, ds.queries,
            pe.medoid, params)
    runs = [tsearch.filtered_search_pipelined(*args, hop_chunk=8,
                                              min_bucket=2,
                                              async_readback=True)
            for _ in range(2)]
    single = tsearch.filtered_search(*args)
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(runs[1], f), getattr(runs[0], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(single, f)), f
    _assert_same(want, runs[0], f"{mode}: compacted, async readback")

    ctx, st = tsearch.init_search(*args)
    before = tsearch.HopState(*(t.clone() for t in st))
    out = tsearch.run_hops(pe.store, pe.codes, pe.mem, ctx, st, 4, params)
    assert out.visited is st.visited
    assert not torch.equal(st.visited, before.visited)
    again = tsearch.run_hops(pe.store, pe.codes, pe.mem, ctx, before, 4,
                             params)
    for f, a, b in zip(tsearch.HopState._fields, again, out):
        assert torch.equal(a, b), f


def test_engine_search_matches_repro(shared_ds, shared_engine, port):
    """The routed engine path under the speculative policy on mixed
    label / label_and / range / hybrid selectors: mechanisms, ids and every
    QueryStats field equal."""
    ds, e, pe = shared_ds, shared_engine, port
    nq = 12
    sels, tsels = [], []
    for wl in ("label", "label_and", "range", "hybrid"):
        sels += make_selectors(ds, e, wl, n_queries=nq)
        tsels += t_make_selectors(ds, pe, wl, n_queries=nq)
    queries = np.concatenate([ds.queries[:nq]] * 4)
    want = e.search(queries, sels, eng.SearchConfig())
    got = pe.search(queries, tsels, teng.SearchConfig())
    assert got[2].mechanism == want[2].mechanism
    assert len(set(want[2].mechanism)) >= 2, "expected a mix of routes"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    for f in ("io_pages", "est_io_pages", "dist_comps", "est_compute",
              "hops", "fp_explored", "explored", "n_valid", "selectivity",
              "precision_in", "faults", "retries", "degraded"):
        np.testing.assert_array_equal(getattr(got[2], f),
                                      getattr(want[2], f), err_msg=f)


def test_results_valid_and_recall(shared_ds, port):
    """Every returned id passes exact membership, and recall@10 against
    the brute-force ground truth stays high on the mixed workload."""
    ds, pe = shared_ds, port
    cfg = pe.config
    sels = t_make_selectors(ds, pe, "hybrid")
    ids, _, _ = pe.search(ds.queries, sels, teng.SearchConfig())
    rec = []
    for i, s in enumerate(sels):
        qf = s.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
        gt = teng.brute_force_filtered(pe.store.vectors, pe.store.rec_labels,
                                       pe.store.rec_values, qf,
                                       ds.queries[i], 10)
        rec.append(teng.recall_at_k(ids[i], gt, 10))
        got = ids[i][ids[i] >= 0]
        if got.size:
            ok = teng.is_member(
                teng.filter_to_device(t_stack_filters([qf]), "cpu"),
                pe.store.rec_labels[None, got], pe.store.rec_values[None, got])
            assert bool(ok.all()), f"query {i} returned invalid ids"
    assert np.mean(rec) >= 0.9, np.mean(rec)


def _same_search(a, b, sels, ds, tag):
    """``engine.search`` of two port engines on the same batch: routes, ids,
    distances and integer counters equal."""
    scfg = teng.SearchConfig(k=10, l=32, max_hops=200)
    q = ds.queries[:len(sels)]
    ia, da, sa = a.search(q, sels, scfg)
    ib, db, sb = b.search(q, sels, scfg)
    assert sa.mechanism == sb.mechanism, tag
    np.testing.assert_array_equal(ia, ib, err_msg=tag)
    np.testing.assert_array_equal(da, db, err_msg=tag)
    for f in ("io_pages", "hops", "dist_comps", "n_valid", "explored",
              "fp_explored"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                      err_msg=f"{tag}: {f}")
    return sb


def test_out_of_scope_paths_raise(port, shared_engine, shared_ds, tmp_path):
    """Sharding (ROADMAP item 7) and a custom distance function (8) raise,
    naming their item, and sharding a disk-backend engine or index raises
    ``repro``'s ValueError. The disk tier (item 6) is ported
    (tests/test_torch_storage.py): here ``to_disk`` and
    ``attach_disk_store`` work on the CPU on the shared engine's copies, and
    a checkpoint of the JAX package's disk backend loads in the port; all
    three answer as the device backend does."""
    import copy
    from repro import api as japi
    from repro_torch import api as tapi
    from repro_torch.storage import DiskRecordStore
    with pytest.raises(NotImplementedError, match="item 7"):
        port.shard(2)
    with pytest.raises(NotImplementedError, match="item 8"):
        tsearch.check_distance_fn(lambda c, t: None)
    vecs = np.zeros((4, 8), np.float32)
    meta = [{"cat": 1}] * 4
    with pytest.raises(ValueError, match="device backend"):
        tapi.Index.build(vecs, meta, store="disk", shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tapi.Index.build(vecs, meta, shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tapi.Index.load(str(tmp_path / "idx"), shards=2)

    sels = t_make_selectors(shared_ds, port, "label")[:8]
    spilled = copy.copy(port).to_disk(str(tmp_path / "slabs"))
    assert spilled.disk_store.n == port.n and spilled.store.n == 1
    st = _same_search(port, spilled, sels, shared_ds, "to_disk")
    assert st.disk["records_fetched"] > 0
    with pytest.raises(ValueError, match="device backend"):
        spilled.shard(2)
    attached = copy.copy(port)
    attached.attach_disk_store(DiskRecordStore(str(tmp_path / "slabs")))
    _same_search(port, attached, sels, shared_ds, "attach_disk_store")

    # a checkpoint of the JAX package's disk backend
    je = copy.copy(shared_engine)
    je.to_disk(str(tmp_path / "jslabs"))
    vocab = {("label", i): i for i in range(shared_ds.n_labels)}
    jidx = japi.Index(je, vocab, japi.Schema(tags=("label",),
                                             nums=("value",)))
    jidx.save(str(tmp_path / "jdisk"))
    loaded = tapi.Index.load(str(tmp_path / "jdisk"), device="cpu")
    assert loaded.engine.disk_store is not None and len(loaded) == port.n
    _same_search(port, loaded.engine, sels, shared_ds, "repro disk ckpt")


# ---------------------------------------------------------------------------
# The read-fault ladder (core/faults.py, the hop step's retry → hedge →
# degrade) against tests/test_faults.py's plans
# ---------------------------------------------------------------------------

FAULT_PLANS = {
    "rate0.1_seed7": dict(seed=7, read_fail_rate=0.1),
    "ladder_off_rate0.5": dict(seed=7, read_fail_rate=0.5, max_retries=0,
                               hedge=False),
}


@pytest.mark.parametrize("stream,attempt", [(1, 0), (2, 3), (3, 0)])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_fault_draws_match_repro(stream, attempt, seed):
    """``_uniform`` bit for bit on ids and hops spanning [0, 2**32) (int32
    views of uint32 values, so ids >= 2**31 come in negative)."""
    from repro.core import faults as jf
    from repro_torch.core import faults as tf
    rng = np.random.default_rng(seed % 1000 + stream)
    ids = rng.integers(0, 2 ** 32, (32, 8), dtype=np.int64).astype(np.uint32)
    ids[0, :4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    hops = rng.integers(0, 2 ** 32, (32, 1), dtype=np.int64).astype(np.uint32)
    want = np.asarray(jf._uniform(jnp.asarray(ids), jnp.asarray(hops), seed,
                                  stream, attempt))
    got = tf._uniform(torch.from_numpy(ids.view(np.int32)),
                      torch.from_numpy(hops.view(np.int32)), seed, stream,
                      attempt).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("attempt", [0, 2])
def test_read_attempt_bad_and_spike_match_repro(attempt):
    from repro.core import faults as jf
    from repro_torch.core import faults as tf
    rng = np.random.default_rng(attempt)
    ids = rng.integers(0, 2 ** 32, (16, 64), dtype=np.int64).astype(np.uint32)
    hops = rng.integers(0, 2 ** 32, (16, 1), dtype=np.int64).astype(np.uint32)
    kw = dict(seed=11, read_fail_rate=0.3, corrupt_rate=0.1, spike_rate=0.2)
    jp, tp = jf.FaultPlan(**kw), tf.FaultPlan(**kw)
    ji, jh = jnp.asarray(ids), jnp.asarray(hops)
    ti = torch.from_numpy(ids.view(np.int32))
    th = torch.from_numpy(hops.view(np.int32))
    want = np.asarray(jf.read_attempt_bad(ji, jh, attempt, jp))
    np.testing.assert_array_equal(
        tf.read_attempt_bad(ti, th, attempt, tp).numpy(), want)
    np.testing.assert_array_equal(tf.read_spike(ti, th, tp).numpy(),
                                  np.asarray(jf.read_spike(ji, jh, jp)))


def test_parse_plan_matches_repro():
    from repro.core import faults as jf
    from repro_torch.core import faults as tf
    for spec in ("rate=0.1,seed=7,max_retries=2,hedge=1",
                 "rate=0.25,seed=7,max_retries=1,hedge=0,corrupt_rate=0.1"):
        assert tf.parse_plan(spec).to_json() == jf.parse_plan(spec).to_json()
    p = tf.parse_plan("rate=0.1,seed=7,max_retries=2,hedge=1")
    assert tf.FaultPlan.from_json(p.to_json()) == p
    assert p.attempts == 4 and p.reads_faulty
    with pytest.raises(ValueError, match="unknown FaultPlan field"):
        tf.parse_plan("nope=1")
    with pytest.raises(AssertionError):
        tf.FaultPlan(read_fail_rate=1.5)


def _fault_pair(ds, e, pe, mode, plan_kw):
    from repro.core.faults import FaultPlan as JPlan
    from repro_torch.core.faults import FaultPlan as TPlan
    nq = ds.queries.shape[0]
    sels = make_sliding_range_selectors(e, 0.30, nq)
    tsels = t_make_sliding(pe, 0.30, nq)
    qf = stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                        for s in sels])
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in tsels])
    kw = dict(l_search=48, k=10, max_hops=200, beam_width=2, mode=mode,
              l_valid=32)
    jp = search_mod.SearchParams(**kw, fault_plan=JPlan(**plan_kw))
    tp = tsearch.SearchParams(**kw, fault_plan=TPlan(**plan_kw))
    entries = _entries(e, sels, mode)
    want = search_mod.filtered_search_pipelined(
        e.store, e.codes, e.codebook, e.mem, qf, jnp.asarray(ds.queries),
        e.medoid, jp,
        entries=None if entries is None else jnp.asarray(entries))
    got = tsearch.filtered_search_pipelined(
        pe.store, pe.codes, pe.codebook, pe.mem, tqf, ds.queries, pe.medoid,
        tp, entries=entries)
    return want, got


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_fault_plan_matches_repro(shared_ds, shared_engine, port, mode,
                                  plan):
    """Every SearchResult field per query equal to repro's under the
    committed 10% plan and under the ladder-off plan at rate 0.5 (W=2, as
    tests/test_faults.py runs it)."""
    want, got = _fault_pair(shared_ds, shared_engine, port, mode,
                            FAULT_PLANS[plan])
    _assert_same(want, got, f"{mode}/{plan}")
    assert int(got.faults.sum()) > 0
    if plan.startswith("ladder_off"):
        assert int(got.degraded.sum()) > 0
        assert int(got.retries.sum()) == 0


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_zero_rate_plan_bit_identical(shared_ds, port, mode):
    """A plan whose rates are all zero leaves every field bit-identical to
    no plan."""
    from repro_torch.core.faults import FaultPlan
    ds, pe = shared_ds, port
    nq = ds.queries.shape[0]
    sels = t_make_sliding(pe, 0.30, nq)
    qf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                          for s in sels])
    ents = None
    if mode == "strict_in":
        ents = np.full((nq, 4), -1, np.int32)
        for j, s in enumerate(sels):
            seeds, _ = teng._strict_seed_ids(s, pe.medoid, 4)
            ents[j, :seeds.size] = seeds
    res = []
    for plan in (None, FaultPlan(seed=42)):
        p = tsearch.SearchParams(l_search=48, k=10, max_hops=200,
                                 beam_width=2, mode=mode, l_valid=32,
                                 fault_plan=plan)
        res.append(tsearch.filtered_search_pipelined(
            pe.store, pe.codes, pe.codebook, pe.mem, qf, ds.queries,
            pe.medoid, p, entries=ents))
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(res[0], f), getattr(res[1], f)), f
    assert int(res[1].faults.sum()) == 0


def test_engine_fault_counters_match_repro(shared_ds, shared_engine, port):
    """SearchConfig.fault_plan flows through the routed engine into
    QueryStats, equal to repro's; the 'pre' route draws no faults."""
    from repro.core.faults import parse_plan as j_parse
    from repro_torch.core.faults import parse_plan as t_parse
    ds, e, pe = shared_ds, shared_engine, port
    spec = "rate=0.1,seed=7,max_retries=2,hedge=1"
    sels, tsels = [], []
    for wl in ("label", "range", "hybrid"):
        sels += make_selectors(ds, e, wl, n_queries=4)
        tsels += t_make_selectors(ds, pe, wl, n_queries=4)
    queries = np.concatenate([ds.queries[:4]] * 3)
    want = e.search(queries, sels, eng.SearchConfig(fault_plan=j_parse(spec)))
    got = pe.search(queries, tsels,
                    teng.SearchConfig(fault_plan=t_parse(spec)))
    assert got[2].mechanism == want[2].mechanism
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    for f in ("io_pages", "hops", "explored", "n_valid", "faults",
              "retries", "degraded"):
        np.testing.assert_array_equal(getattr(got[2], f),
                                      getattr(want[2], f), err_msg=f)
    assert got[2].faults.sum() > 0

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
from repro_torch.core import pq as tpq
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
    """Sharding (item 7) is ported (tests/test_torch_distributed.py): here
    ``shard(2)`` toggles on and off on the shared engine, and a shard count
    that is not a power of two, the reference builder with shards, and
    sharding a disk-backend engine or index raise ``repro``'s ValueError. A
    custom distance function (item 8a) is accepted and searched with (one
    call per query row, here equal to the default). The disk tier (item 6)
    is ported
    (tests/test_torch_storage.py): here ``to_disk`` and
    ``attach_disk_store`` work on the CPU on the shared engine's copies, and
    a checkpoint of the JAX package's disk backend loads in the port; all
    three answer as the device backend does."""
    import copy
    from repro import api as japi
    from repro_torch import api as tapi
    from repro_torch.storage import DiskRecordStore
    assert port.shard(2).n_shards == 2
    assert port.shard(0).n_shards == 1
    with pytest.raises(ValueError, match="power of two"):
        port.shard(3)
    # a custom distance is accepted (item 8a): the search runs it
    assert not hasattr(tsearch, "check_distance_fn")
    calls = []

    def adc(codes, table):
        calls.append(codes.shape[0])
        return tpq.adc_lookup(codes, table)

    nq = 4
    tqf = t_stack_filters([s.plan(port.config.ql, port.config.cap).qfilter
                           for s in t_make_sliding(port, 0.30, nq)])
    _, p_torch = _params("post", 1)
    args = (port.store, port.codes, port.codebook, port.mem, tqf,
            shared_ds.queries[:nq], port.medoid, p_torch)
    got = tsearch.filtered_search_pipelined(*args, distance_fn=adc)
    want = tsearch.filtered_search_pipelined(*args)
    assert calls
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    vecs = np.zeros((4, 8), np.float32)
    meta = [{"cat": 1}] * 4
    with pytest.raises(ValueError, match="device backend"):
        tapi.Index.build(vecs, meta, store="disk", shards=2, device="cpu")
    with pytest.raises(ValueError, match="builder='batched'"):
        tapi.Index.build(vecs, meta, tapi.IndexConfig(builder="reference"),
                         shards=2, device="cpu")

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


# ---------------------------------------------------------------------------
# The naive oracles (filtered_search_ref, filtered_search_legacy), the
# distance_fn seam and the compaction trace, against repro and against the
# port's fused path
# ---------------------------------------------------------------------------

def _oracle_inputs(ds, e, pe, mode, selectivity, w=2):
    """One range batch at ``selectivity`` in both packages' forms (W=2, as
    tests/test_search_parity.py runs its A/B grid)."""
    nq = ds.queries.shape[0]
    sels = make_sliding_range_selectors(e, selectivity, nq)
    tsels = t_make_sliding(pe, selectivity, nq)
    qf = stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                        for s in sels])
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in tsels])
    p_jax, p_torch = _params(mode, w)
    entries = _entries(e, sels, mode)
    jargs = (e.store, e.codes, e.codebook, e.mem, qf,
             jnp.asarray(ds.queries), e.medoid, p_jax)
    targs = (pe.store, pe.codes, pe.codebook, pe.mem, tqf, ds.queries,
             pe.medoid, p_torch)
    jent = None if entries is None else jnp.asarray(entries)
    return sels, jargs, targs, jent, entries


@pytest.fixture(scope="module")
def port_oracle(shared_ds, shared_engine, port):
    """The port's oracle on a grid cell (mode, selectivity), computed once
    per module."""
    runs = {}

    def get(mode, selectivity):
        if (mode, selectivity) not in runs:
            _, _, targs, _, ents = _oracle_inputs(
                shared_ds, shared_engine, port, mode, selectivity)
            runs[mode, selectivity] = tsearch.filtered_search_ref(
                *targs, entries=ents)
        return runs[mode, selectivity]
    return get


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
@pytest.mark.parametrize("selectivity", SELECTIVITIES)
def test_ref_matches_repro(shared_ds, shared_engine, port, port_oracle,
                           mode, selectivity):
    """The port's oracle against repro's ``filtered_search_ref`` on the
    same inputs: every SearchResult field per query (ids and counters
    exactly, fault counters zero in both, distances allclose)."""
    ds, e, pe = shared_ds, shared_engine, port
    _, jargs, _, jent, _ = _oracle_inputs(ds, e, pe, mode, selectivity)
    want = search_mod.filtered_search_ref(*jargs, entries=jent)
    got = port_oracle(mode, selectivity)
    _assert_same(want, got, f"ref {mode}@{selectivity}")
    assert int(got.faults.sum() + got.retries.sum()
               + got.degraded.sum()) == 0


def _port_recalls(ds, pe, sels, ids):
    out = []
    for i, s in enumerate(sels):
        qf = s.plan(pe.config.ql, pe.config.cap, pe.config.qr).qfilter
        gt = teng.brute_force_filtered(pe.store.vectors, pe.store.rec_labels,
                                       pe.store.rec_values, qf,
                                       ds.queries[i], 10)
        out.append(teng.recall_at_k(ids[i].numpy(), gt, 10))
    return np.array(out)


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
@pytest.mark.parametrize("selectivity", SELECTIVITIES)
def test_fused_matches_port_oracle(shared_ds, shared_engine, port,
                                   port_oracle, mode, selectivity):
    """repro's A/B bar (tests/test_search_parity.py) inside the port: the
    fused ``filtered_search`` against the port's oracle — identical
    io_pages, explored, hops and n_valid per query (the visited set is
    exact at this size), mean recall@10 within 0.01."""
    ds, e, pe = shared_ds, shared_engine, port
    _, _, targs, _, ents = _oracle_inputs(ds, e, pe, mode, selectivity)
    fused = tsearch.filtered_search(*targs, entries=ents)
    ref = port_oracle(mode, selectivity)
    for f in ("io_pages", "explored", "hops", "n_valid"):
        assert torch.equal(getattr(fused, f), getattr(ref, f)), \
            f"{mode}@{selectivity}: {f}"
    tsels = t_make_sliding(pe, selectivity, ds.queries.shape[0])
    r_f = _port_recalls(ds, pe, tsels, fused.ids)
    r_r = _port_recalls(ds, pe, tsels, ref.ids)
    assert abs(r_f.mean() - r_r.mean()) <= 0.01, (r_f.mean(), r_r.mean())


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_legacy_matches_repro(shared_ds, shared_engine, port, mode):
    """The port's pre-fused baseline against repro's
    ``filtered_search_legacy``: every field per query."""
    ds, e, pe = shared_ds, shared_engine, port
    _, jargs, targs, jent, ents = _oracle_inputs(ds, e, pe, mode, 0.30)
    want = search_mod.filtered_search_legacy(*jargs, entries=jent)
    got = tsearch.filtered_search_legacy(*targs, entries=ents)
    _assert_same(want, got, f"legacy {mode}")


def _j_scaled_adc(codes, table):        # distinct identity and values
    from repro.core import pq as jpq
    return jpq.adc_lookup(codes, table) * jnp.float32(2.0)


def _t_scaled_adc(codes, table):
    return tpq.adc_lookup(codes, table) * 2.0


SEARCH_ENTRIES = ("hop_fused_gather", "pq_scan", "pq_scan_gather",
                  "or_scatter_", "or_scatter_new")


@pytest.fixture
def entry_calls(monkeypatch):
    """Counts calls of the ``kernels.ops`` entries the search path uses
    (the port calls them through the module, so wrapping its names sees
    every call); on the CPU no kernel launches, so calls stand in for
    launches."""
    from repro_torch.kernels import ops
    calls = dict.fromkeys(SEARCH_ENTRIES, 0)
    for name in SEARCH_ENTRIES:
        def call(*a, _name=name, _fn=getattr(ops, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, call)
    return calls


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_custom_distance_fn_matches_repro(shared_ds, shared_engine, port,
                                          mode, entry_calls):
    """A scaled-ADC ``distance_fn`` in each package (as
    tests/test_search_parity.py does): the port's fused result equals its
    oracle's and repro's fused result on every field, and spec_in screens
    without the fused kernel. The default path calls the ``ops`` entries
    it called before the seam existed — ``None`` and ``pq.adc_lookup``
    alike — and launches (``ops.snapshot``) the same."""
    from repro_torch.kernels import ops
    ds, e, pe = shared_ds, shared_engine, port
    _, jargs, targs, jent, ents = _oracle_inputs(ds, e, pe, mode, 0.30, 1)
    want = search_mod.filtered_search(*jargs, distance_fn=_j_scaled_adc,
                                      entries=jent)
    got = tsearch.filtered_search(*targs, entries=ents,
                                  distance_fn=_t_scaled_adc)
    custom = dict(entry_calls)
    ref = tsearch.filtered_search_ref(*targs, entries=ents,
                                      distance_fn=_t_scaled_adc)
    _assert_same(want, got, f"scaled ADC, fused vs repro, {mode}")
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert custom["hop_fused_gather"] == 0 and custom["pq_scan"] == 0

    counts = []
    for fn in (None, tpq.adc_lookup):
        entry_calls.update(dict.fromkeys(SEARCH_ENTRIES, 0))
        before = ops.snapshot()
        res = tsearch.filtered_search(*targs, entries=ents, distance_fn=fn)
        counts.append((dict(entry_calls), ops.snapshot() == before))
        if fn is not None:
            for f in tsearch.SearchResult._fields:
                assert torch.equal(getattr(res, f), getattr(first, f)), f
        first = res
    assert counts[0] == counts[1]
    calls = counts[0][0]
    # one in-place visited update and, in spec_in, one fused pass a hop
    assert calls["or_scatter_"] > 0
    assert calls["pq_scan"] == calls["pq_scan_gather"] == 0
    assert calls["hop_fused_gather"] == (calls["or_scatter_"]
                                         if mode == "spec_in" else 0)


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_pq_scan_distance_equals_default(shared_ds, port, mode,
                                         entry_calls):
    """``distance_fn=ops.pq_scan`` (its plain version on the CPU) equals
    the default path on every field through the compacting driver and
    through the oracle, calling the slab entry once per query row of every
    slab."""
    from repro_torch.kernels import ops
    ds, pe = shared_ds, port
    nq = ds.queries.shape[0]
    tsels = t_make_sliding(pe, 0.30, nq)
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in tsels])
    _, params = _params(mode, 1)
    ents = None
    if mode == "strict_in":
        ents = np.full((nq, 4), -1, np.int32)
        for j, s in enumerate(tsels):
            seeds, _ = teng._strict_seed_ids(s, pe.medoid, 4)
            ents[j, :seeds.size] = seeds
    args = (pe.store, pe.codes, pe.codebook, pe.mem, tqf, ds.queries,
            pe.medoid, params)
    default = tsearch.filtered_search_pipelined(*args, entries=ents)
    entry_calls.update(dict.fromkeys(SEARCH_ENTRIES, 0))
    scanned = tsearch.filtered_search_pipelined(*args, entries=ents,
                                                distance_fn=ops.pq_scan)
    assert entry_calls["pq_scan"] > 0 and entry_calls["hop_fused_gather"] == 0
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(scanned, f), getattr(default, f)), f
    ref = tsearch.filtered_search_ref(*args, entries=ents)
    ref_scan = tsearch.filtered_search_ref(*args, entries=ents,
                                           distance_fn=ops.pq_scan)
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(ref_scan, f), getattr(ref, f)), f


def test_prefilter_distance_fn_matches_repro(shared_ds, shared_engine,
                                             port):
    """``prefilter_search(distance_fn=)`` and ``scan_all_gated(
    distance_fn=)`` with the scaled ADC equal repro's."""
    from repro.core import prefilter as jpre
    from repro_torch.core import prefilter as tpre
    from repro_torch.core.selectors import filter_to_device
    ds, e, pe = shared_ds, shared_engine, port
    nq = 8
    sels = make_selectors(ds, e, "label", n_queries=nq)
    tsels = t_make_selectors(ds, pe, "label", n_queries=nq)
    qf = stack_filters([s.plan(e.config.ql, e.config.cap).qfilter
                        for s in sels])
    tqf = t_stack_filters([s.plan(pe.config.ql, pe.config.cap).qfilter
                           for s in tsels])
    q = ds.queries[:nq]
    want = jpre.prefilter_search(
        e.store, e.codes, e.codebook, sels, qf, jnp.asarray(q),
        jpre.PrefilterParams(l_rerank=48), distance_fn=_j_scaled_adc)
    got = tpre.prefilter_search(
        pe.store, pe.codes, pe.codebook, tsels, tqf, q,
        tpre.PrefilterParams(l_rerank=48), distance_fn=_t_scaled_adc)
    for f in ("ids", "io_pages", "dist_comps", "n_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-6, atol=1e-6)
    dev_qf = filter_to_device(tqf, "cpu")
    for b in range(3):
        jqf = type(qf)(*(np.asarray(x)[b] for x in qf))
        w_ids, w_keys = jpre.scan_all_gated(
            e.codes, e.codebook, e.mem, jqf, jnp.asarray(q[b]), 48,
            jpre.SCAN_CHUNK, _j_scaled_adc)
        g_ids, g_keys = tpre.scan_all_gated(
            pe.codes, pe.codebook, pe.mem,
            type(dev_qf)(*(x[b:b + 1] for x in dev_qf)),
            torch.from_numpy(q[b]), 48, distance_fn=_t_scaled_adc)
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
        np.testing.assert_array_equal(g_keys.numpy(), np.asarray(w_keys))


@pytest.mark.parametrize("async_readback", [True, False])
def test_collect_trace_matches_repro(shared_ds, shared_engine, port,
                                     async_readback):
    """``collect_trace=True``: the port's per-chunk trace equals repro's
    with the synchronous and the async readback, and the result equals
    the untraced one; ``hop_chunk=0`` gives ``(res, [])``."""
    ds, e, pe = shared_ds, shared_engine, port
    _, jargs, targs, _, _ = _oracle_inputs(ds, e, pe, "spec_in", 0.30, 1)
    kw = dict(hop_chunk=8, min_bucket=2, async_readback=async_readback)
    want, jtrace = search_mod.filtered_search_pipelined(
        *jargs, collect_trace=True, **kw)
    got, trace = tsearch.filtered_search_pipelined(*targs,
                                                   collect_trace=True, **kw)
    assert len(trace) > 2 and trace == jtrace
    plain = tsearch.filtered_search_pipelined(*targs, **kw)
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    _assert_same(want, got, f"traced, async={async_readback}")
    single, empty = tsearch.filtered_search_pipelined(
        *targs, hop_chunk=0, collect_trace=True)
    assert empty == []
    for f in tsearch.SearchResult._fields:
        assert torch.equal(getattr(single, f), getattr(plain, f)), f

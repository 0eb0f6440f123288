"""Sharded execution of the PyTorch port against the JAX package.

``repro``'s mesh code runs in process on one device
(``make_local_mesh(1, 1)``): each query row's trajectory, and each build
row's navigation and prune, is independent of the other rows, and a tiled
all-gather restores the row order, so ``repro``'s one-shard result is the
reference for every shard count. The port's shards are ``local_plan(S,
"cpu")``: S shards on the CPU.

Search: ids and every integer field of ``SearchResult`` equal to ``repro``'s
exactly, distances ``allclose(1e-6, 1e-6)`` against ``repro`` and bit for
bit against the port's unsharded run. Build: the sharded build with exact
navigation equals ``repro``'s ``build_vamana_batched`` element for element;
with PQ navigation (``repro``'s codes and codebook) it equals ``repro``'s
``build_vamana_sharded``. The facade, the engine and the server are held
equal to the same index unsharded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import engine as eng
from repro.core import graph as jgraph
from repro.core import pq as jpq
from repro.core import search as jsearch
from repro.core.selectors import stack_filters
from repro.data.synth import make_filtered_dataset, make_selectors
from repro.launch.mesh import make_local_mesh
from repro_torch import api as tapi
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as teng
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.core.selectors import stack_filters as t_stack_filters
from repro_torch.data.synth import make_selectors as t_make_selectors
from repro_torch.kernels import ops as tops
from repro_torch.serve import SearchServer, ServerConfig
from torch_port_helpers import port_engine

INT_FIELDS = ("ids", "io_pages", "hops", "dist_comps", "approx_checks",
              "n_valid", "fp_explored", "explored", "faults", "retries",
              "degraded")
MODES = ("post", "spec_in", "strict_in")


def _one_device_plan():
    return jdist.ShardPlan(mesh=make_local_mesh(1, 1),
                           shard_axes=("model",))


@pytest.fixture(scope="module")
def setup():
    """A ``repro`` engine (n=1024, d=16, r=12, pq_m=8), its port, the
    label_or batch of 33 queries (a padded bucket) in both packages' filter
    form, the strict_in entry seeds, and ``repro``'s one-device runner."""
    ds = make_filtered_dataset(n=1024, d=16, n_queries=33, n_labels=30,
                               seed=0)
    cfg = eng.IndexConfig(r=12, r_dense=96, l_build=24, pq_m=8,
                          max_labels=16)
    e = eng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                    ds.label_flat, ds.n_labels, ds.values,
                                    cfg)
    pe = port_engine(e, ds)
    sels = make_selectors(ds, e, "label_or")
    qf = stack_filters([s.plan(cfg.ql, cfg.cap).qfilter for s in sels])
    tqf = t_stack_filters([s.plan(cfg.ql, cfg.cap).qfilter
                           for s in t_make_selectors(ds, pe, "label_or")])
    ents = np.full((len(sels), 4), -1, np.int32)
    for j, s in enumerate(sels):
        seeds, _ = eng._strict_seed_ids(s, e.medoid, 4)
        ents[j, :seeds.size] = seeds
    runner = jdist.ShardedSearchRunner(_one_device_plan(), e.store, e.codes,
                                       e.codebook, e.mem)
    return dict(ds=ds, e=e, pe=pe, qf=qf, tqf=tqf, ents=ents, runner=runner,
                want={})


def _params(mode, w, fault_kw=None):
    from repro.core.faults import FaultPlan as JPlan
    from repro_torch.core.faults import FaultPlan as TPlan
    kw = dict(l_search=32, k=10, max_hops=64, l_valid=24, beam_width=w,
              mode=mode)
    return (jsearch.SearchParams(**kw, fault_plan=fault_kw and JPlan(
                **fault_kw)),
            tsearch.SearchParams(**kw, fault_plan=fault_kw and TPlan(
                **fault_kw)))


def _repro_run(st, mode, jp, distance_fn=jpq.adc_lookup):
    """``repro``'s driver through its one-device runner, in one
    ``max_hops`` chunk at one width (one compile; no row compacts, and the
    results do not depend on compaction)."""
    ents = st["ents"] if mode == "strict_in" else None
    e = st["e"]
    return jsearch.filtered_search_pipelined(
        e.store, e.codes, e.codebook, e.mem, st["qf"],
        jnp.asarray(st["ds"].queries), e.medoid, jp, hop_chunk=0,
        min_bucket=64, entries=None if ents is None else jnp.asarray(ents),
        distance_fn=distance_fn, runner=st["runner"])


def _port_run(st, mode, tp, runner=None, hop_chunk=16, distance_fn=None):
    pe = st["pe"]
    return tsearch.filtered_search_pipelined(
        pe.store, pe.codes, pe.codebook, pe.mem, st["tqf"],
        st["ds"].queries, pe.medoid, tp,
        entries=st["ents"] if mode == "strict_in" else None,
        hop_chunk=hop_chunk, runner=runner, distance_fn=distance_fn)


def _assert_same(want, got, base, tag):
    """Integer fields equal to ``repro``'s, distances allclose to
    ``repro``'s and bit for bit the port's unsharded ``base``."""
    for f in INT_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        bad = np.flatnonzero((w != g).reshape(w.shape[0], -1).any(1))
        assert bad.size == 0, (f"{tag}: {f} differs first at query "
                               f"{bad[0]}: repro={w[bad[0]]} port={g[bad[0]]}")
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-6, atol=1e-6, err_msg=tag)
    for f in got._fields:
        a, b = getattr(got, f), getattr(base, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{tag}: {f} differs from unsharded"


# ---------------------------------------------------------------------------
# Store layout and the two fetch flavours
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3, 4])
def test_pad_store_and_shardings_match_repro(setup, shards):
    """A 1022-row store (a shard multiple at S=2 only) padded as ``repro``
    pads it; each shard holds its contiguous block, as views of the one
    store when nothing was padded."""
    from repro.core.records import RecordStore as JStore
    from repro_torch.core.records import RecordStore as TStore
    e, pe = setup["e"], setup["pe"]
    n = 1022
    js = JStore(*(getattr(e.store, f)[:n] for f in tdist._RECORD_FIELDS),
                e.store.pages_std, e.store.pages_dense,
                cand_first=e.store.cand_first[:n])
    ts = TStore(*(getattr(pe.store, f)[:n] for f in tdist._RECORD_FIELDS),
                pe.store.pages_std, pe.store.pages_dense,
                cand_first=pe.store.cand_first[:n])
    jp, tp = jdist.pad_store(js, shards), tdist.pad_store(ts, shards)
    assert tp.n == jp.n and tp.n % shards == 0
    assert (tp.pages_std, tp.pages_dense) == (jp.pages_std, jp.pages_dense)
    for f in tdist._RECORD_FIELDS + ("cand_first",):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    parts = tdist.store_shardings(tdist.local_plan(shards, "cpu"), tp)
    size = tp.n // shards
    for s, part in enumerate(parts):
        assert part.n == size and part.degree == tp.degree
        for f in tdist._RECORD_FIELDS + ("cand_first",):
            assert torch.equal(getattr(part, f),
                               getattr(tp, f)[s * size:(s + 1) * size]), f
            if tp.n == n:
                assert getattr(part, f).data_ptr() == (
                    getattr(tp, f)[s * size:].data_ptr()), f"{f} copied"


@pytest.mark.parametrize("shards", [2, 4])
def test_fetch_flavours_match_local_fetch(setup, shards):
    """The replicated-ids fetch (ids of shape (B, W·R), as strict_in reads
    them) and the row-sharded fetch (one block per shard) give
    ``local_fetch``'s records, ``cand_first`` included."""
    pe = setup["pe"]
    plan = tdist.local_plan(shards, "cpu")
    parts = tdist.store_shardings(plan, tdist.pad_store(pe.store, shards))
    rng = np.random.default_rng(shards)
    ids = torch.from_numpy(rng.integers(0, pe.store.n, (6, 24))
                           .astype(np.int32))
    ids[0, :3] = torch.tensor([0, pe.store.n - 1, 0])
    want = tsearch.local_fetch(pe.store, ids.reshape(-1))
    assert "cand_first" in want
    got = tdist.make_sharded_fetch(plan, parts)(parts[0], ids)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.reshape(ids.shape + v.shape[1:])), k
    blocks = [ids[s].reshape(2, -1) for s in range(shards)]
    got = tdist.make_batch_sharded_fetch(plan, parts)(None, blocks)
    assert len(got) == shards
    for s, rec in enumerate(got):
        for k, v in tsearch.local_fetch(pe.store, ids[s]).items():
            assert torch.equal(rec[k], v.reshape((2, 12) + v.shape[1:])), k


# ---------------------------------------------------------------------------
# The row-sharded runner through the pipelined driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hop_chunk", [16, 0])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_runner_matches_repro(setup, mode, w, shards, hop_chunk):
    """``filtered_search_pipelined(runner=)`` at S shards against
    ``repro``'s driver with its one-device runner (33 queries: a padded
    bucket; ``hop_chunk=0`` is one ``max_hops`` chunk through the
    runner)."""
    jp, tp = _params(mode, w)
    key = (mode, w)
    if key not in setup["want"]:
        setup["want"][key] = (_repro_run(setup, mode, jp),
                              _port_run(setup, mode, tp))
    want, base = setup["want"][key]
    pe = setup["pe"]
    runner = tdist.ShardedSearchRunner(tdist.local_plan(shards, "cpu"),
                                       pe.store, pe.codes, pe.codebook,
                                       pe.mem)
    got = _port_run(setup, mode, tp, runner=runner, hop_chunk=hop_chunk)
    _assert_same(want, got, base, f"{mode} W={w} S={shards} "
                                  f"chunk={hop_chunk}")


def test_runner_under_fault_plan_matches_repro(setup):
    """spec_in at W=2, S=2, under a read-fault plan: the ladder's draws key
    on (id, the row's own hop counter), so sharding the rows moves none."""
    kw = dict(seed=7, read_fail_rate=0.3)
    jp, tp = _params("spec_in", 2, kw)
    want = _repro_run(setup, "spec_in", jp)
    assert int(np.asarray(want.faults).sum()) > 0
    pe = setup["pe"]
    runner = tdist.ShardedSearchRunner(tdist.local_plan(2, "cpu"), pe.store,
                                       pe.codes, pe.codebook, pe.mem)
    _assert_same(want, _port_run(setup, "spec_in", tp, runner=runner),
                 _port_run(setup, "spec_in", tp), "fault plan S=2")


def _j_scaled_adc(codes, table):
    return jpq.adc_lookup(codes, table) * jnp.float32(2.0)


def _t_scaled_adc(codes, table):
    return tpq.adc_lookup(codes, table) * 2.0


def test_runner_custom_distance_matches_repro(setup):
    """A scaled-ADC ``distance_fn`` through the runner at S=4 (spec_in then
    screens with ``is_member_approx``, not ``hop_fused``)."""
    mode = "spec_in"
    jp, tp = _params(mode, 1)
    want = _repro_run(setup, mode, jp, distance_fn=_j_scaled_adc)
    pe = setup["pe"]
    runner = tdist.ShardedSearchRunner(tdist.local_plan(4, "cpu"), pe.store,
                                       pe.codes, pe.codebook, pe.mem)
    got = _port_run(setup, mode, tp, runner=runner,
                    distance_fn=_t_scaled_adc)
    _assert_same(want, got, _port_run(setup, mode, tp,
                                      distance_fn=_t_scaled_adc),
                 f"scaled ADC {mode}")


def test_runner_trace_and_refusals(setup):
    """``collect_trace`` runs through the runner (buckets never below S);
    a shard count that is not a power of two raises ``repro``'s error."""
    _, tp = _params("post", 1)
    pe = setup["pe"]
    runner = tdist.ShardedSearchRunner(tdist.local_plan(4, "cpu"), pe.store,
                                       pe.codes, pe.codebook, pe.mem)
    res, trace = tsearch.filtered_search_pipelined(
        pe.store, pe.codes, pe.codebook, pe.mem,
        type(setup["tqf"])(*(x[:3] for x in setup["tqf"])),
        setup["ds"].queries[:3], pe.medoid, tp, hop_chunk=16,
        runner=runner, collect_trace=True)
    assert trace and all(t["bucket"] >= 8 for t in trace)
    assert res.ids.shape == (3, 10)
    with pytest.raises(ValueError, match="power of two"):
        tdist.ShardedSearchRunner(tdist.local_plan(3, "cpu"), pe.store,
                                  pe.codes, pe.codebook, pe.mem)
    assert not hasattr(runner, "cache_size")


@pytest.mark.parametrize("shards", [2, 4])
def test_distributed_search_matches_local(setup, shards):
    """The replicated-queries entry against ``repro``'s local
    ``filtered_search`` (tests/test_distributed.py's check, every field)."""
    e, pe = setup["e"], setup["pe"]
    jp, tp = _params("spec_in", 1)
    want = jsearch.filtered_search(e.store, e.codes, e.codebook, e.mem,
                                   setup["qf"],
                                   jnp.asarray(setup["ds"].queries),
                                   e.medoid, jp)
    got = tdist.distributed_filtered_search(
        tdist.local_plan(shards, "cpu"), pe.store, pe.codes, pe.codebook,
        pe.mem, setup["tqf"], setup["ds"].queries, pe.medoid, tp)
    base = tsearch.filtered_search(pe.store, pe.codes, pe.codebook, pe.mem,
                                   setup["tqf"], setup["ds"].queries,
                                   pe.medoid, tp)
    _assert_same(want, got, base, f"replicated S={shards}")


# ---------------------------------------------------------------------------
# The sharded Vamana build
# ---------------------------------------------------------------------------

BUILD = dict(r=12, ell=24, batch=256, seed=3)


@pytest.fixture(scope="module")
def build_data():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((768, 16), dtype=np.float32)
    adj_b, med_b = jgraph.build_vamana_batched(data, **BUILD)
    cb = jpq.train_pq(jax.random.PRNGKey(0), data, m=8, iters=4)
    codes = jpq.encode_pq(cb, data)
    adj_p, med_p = jdist.build_vamana_sharded(
        data, _one_device_plan(), codes=codes, codebook=cb, **BUILD)
    return dict(data=data, batched=(adj_b, med_b), pq=(adj_p, med_p),
                codes=np.array(codes),
                codebook=tpq.PQCodebook(
                    torch.from_numpy(np.array(cb.centroids)), cb.dim))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_build_exact_matches_batched(build_data, shards):
    """Exact navigation: ``repro``'s batched build, element for element,
    with ``prune_scan``'s plain version on every shard's rows."""
    st = {}
    tops.reset_launches()
    adj, med = tdist.build_vamana_sharded(
        build_data["data"], tdist.local_plan(shards, "cpu"),
        stage_times=st, **BUILD)
    adj_b, med_b = build_data["batched"]
    assert med == med_b
    np.testing.assert_array_equal(adj, adj_b)
    assert set(st) == {"nav_prune_s", "scatter_s"}
    assert st["nav_prune_s"] > 0 and st["scatter_s"] > 0


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_build_pq_matches_repro(build_data, shards):
    """PQ navigation on ``repro``'s codes and codebook: ``repro``'s
    ``build_vamana_sharded``, element for element, and ``repro``'s recall
    bar against the batched build (tests/test_distributed.py)."""
    data = build_data["data"]
    adj, med = tdist.build_vamana_sharded(
        data, tdist.local_plan(shards, "cpu"), codes=build_data["codes"],
        codebook=build_data["codebook"], **BUILD)
    adj_p, med_p = build_data["pq"]
    assert med == med_p
    np.testing.assert_array_equal(adj, adj_p)
    queries = np.random.default_rng(1).standard_normal((32, 16),
                                                       dtype=np.float32)
    adj_b, med_b = build_data["batched"]
    rb = jgraph.greedy_recall_at_k(data, adj_b, med_b, queries, ell=32, k=10)
    rp = jgraph.greedy_recall_at_k(data, adj, med, queries, ell=32, k=10)
    assert rp >= rb - 0.01, (rp, rb)


def test_sharded_build_batch_must_divide(build_data):
    with pytest.raises(AssertionError, match="divide"):
        tdist.build_vamana_sharded(build_data["data"][:40],
                                   tdist.local_plan(4, "cpu"), r=4, ell=8,
                                   batch=34)


# ---------------------------------------------------------------------------
# The engine, the facade and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    vectors = rng.normal(0, 1, (600, 24)).astype(np.float32)
    metadata = [{"cat": sorted(set(int(x) for x in
                               rng.integers(0, 8, rng.integers(1, 4)))),
                 "value": float(v)}
                for v in rng.uniform(0, 100, 600)]
    return vectors, metadata


CFG = tapi.IndexConfig(r=12, r_dense=60, l_build=24, pq_m=8)
DEFAULTS = tapi.SearchConfig(k=5, l=16, max_hops=60)


def _requests(vectors, n=12):
    tag, num = tapi.Tag("cat"), tapi.Num("value")
    return [tapi.SearchRequest(query=vectors[i] + 0.01,
                               filter=(tag == 2, num < 50.0,
                                       (tag == 2) | (num < 60.0))[i % 3],
                               policy=("post", "strict_in",
                                       "speculative")[i % 3])
            for i in range(n)]


def _same_answers(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.ids, y.ids)
        np.testing.assert_array_equal(x.dists, y.dists)


@pytest.fixture(scope="module")
def sharded_index(corpus):
    vectors, metadata = corpus
    return tapi.Index.build(vectors, metadata, CFG, defaults=DEFAULTS,
                            shards=2, device="cpu")


def test_index_build_sharded_serves_like_unsharded(corpus, sharded_index):
    """``Index.build(shards=2)``: PQ-navigated sharded build stages, a
    sharded engine, and answers equal to the same index after
    ``engine.shard(0)``; the graph routes went through the runner."""
    idx = sharded_index
    e = idx.engine
    assert e.n_shards == 2 and {"nav_prune_s", "scatter_s"} <= set(
        e.build_times)
    reqs = _requests(corpus[0])
    calls = []
    run = e._runner.run
    e._runner.run = lambda *a, **k: calls.append(1) or run(*a, **k)
    try:
        got, stats = idx.search_batch(reqs, with_stats=True)
    finally:
        del e._runner.run
    assert calls and {"in", "post"} <= set(stats.mechanism)
    e.shard(0)
    try:
        assert e.n_shards == 1
        _same_answers(got, idx.search_batch(reqs))
    finally:
        e.shard(2)


def test_index_load_sharded_and_insert(corpus, sharded_index, tmp_path):
    """``Index.load(path, shards=2)`` answers as the unsharded load; the
    same insert into both leaves them equal (the runner re-shards over the
    grown stores); ``to_disk`` drops the runner."""
    vectors, metadata = corpus
    path = str(tmp_path / "ckpt")
    sharded_index.save(path)
    plain = tapi.Index.load(path, device="cpu")
    sharded = tapi.Index.load(path, shards=2, device="cpu")
    assert plain.engine.n_shards == 1 and sharded.engine.n_shards == 2
    reqs = _requests(vectors)
    _same_answers(sharded.search_batch(reqs), plain.search_batch(reqs))
    extra = vectors[:40] + 0.5
    for idx in (plain, sharded):
        ids = idx.insert(extra, metadata[:40])
        assert ids.tolist() == list(range(600, 640))
    runner = sharded.engine._runner
    assert runner is not None and sum(s.n for s in runner.shards) >= 640
    reqs += [dataclasses.replace(r, query=extra[i]) for i, r in
             enumerate(_requests(vectors, 6))]
    _same_answers(sharded.search_batch(reqs), plain.search_batch(reqs))
    sharded.engine.to_disk(str(tmp_path / "slabs"))
    assert sharded.engine.n_shards == 1
    with pytest.raises(ValueError, match="device backend"):
        sharded.engine.shard(2)


def test_sharding_refusals(corpus, sharded_index):
    vectors, metadata = corpus
    with pytest.raises(ValueError, match="power of two"):
        sharded_index.engine.shard(3)
    assert sharded_index.engine.n_shards == 2
    with pytest.raises(ValueError, match="device backend"):
        tapi.Index.build(vectors, metadata, CFG, store="disk", shards=2,
                         device="cpu")
    with pytest.raises(ValueError, match="builder='batched'"):
        teng.FilteredANNEngine.build(
            vectors, np.zeros(601, np.int64), np.zeros(0, np.int32), 1,
            np.zeros(600, np.float32),
            dataclasses.replace(CFG, builder="reference"), shards=2,
            device="cpu")


def test_server_reports_shards_and_serves_like_unsharded(corpus,
                                                         sharded_index):
    """``SearchServer`` over the sharded index: ``stats().shards`` is 2,
    warmup covers the sharded path, and the served answers equal the
    unsharded direct search (``repro``'s jit-cache check has no
    counterpart: the port compiles nothing per width)."""
    idx = sharded_index
    reqs = _requests(corpus[0], 8)
    idx.engine.shard(0)
    try:
        want = idx.search_batch(reqs)
    finally:
        idx.engine.shard(2)
    with SearchServer(idx, ServerConfig(max_batch=8,
                                        max_delay_s=0.05)) as srv:
        srv.warmup(reqs, ladder=False, rungs=())
        assert srv.stats().warmed and srv.stats().shards == 2
        handles = srv.submit_many(reqs)
        got = [h.result(timeout=120) for h in handles]
    _same_answers(got, want)

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


def test_out_of_scope_paths_raise(port, tmp_path):
    from repro_torch import api as tapi
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.insert(None, None, None, 0, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.to_disk("x")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.shard(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsearch.SearchParams(l_search=8, fault_plan=object())
    idx = tapi.Index(port, {}, tapi.Schema())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.save(str(tmp_path / "idx"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.Index.load(str(tmp_path / "idx"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.insert(np.zeros((1, 4), np.float32), [{}])
    vecs = np.zeros((4, 8), np.float32)
    meta = [{"cat": 1}] * 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.Index.build(vecs, meta, store="disk", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.Index.build(vecs, meta, shards=2, device="cpu")

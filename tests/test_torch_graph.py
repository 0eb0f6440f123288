"""The PyTorch port's Vamana builds against the JAX package's, on the
tests/test_graph.py corpus (1500×24, r=24, ell=40, α=1.2, seed 0). The
batched build: the same adjacency checks, the same medoid, recall@10 within
0.01 (both graphs measured by ``repro``'s greedy search); the batched prune
and the reverse-edge scatter against ``repro``'s on fixed inputs. The
sequential reference build (numpy RobustPrune, navigated by the port's
greedy search): the same adjacency and medoid as ``repro``'s, also through
``IndexConfig(builder="reference")``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import graph as jgraph
from repro_torch.core import graph as tgraph
from repro_torch.kernels import ops as tops


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.normal(0, 1, (1500, 24)).astype(np.float32)


@pytest.fixture(scope="module")
def builds(data):
    adj_j, med_j = jgraph.build_vamana_batched(data, r=24, ell=40, alpha=1.2,
                                               seed=0)
    tops.reset_launches()
    times = {}
    adj_t, med_t = tgraph.build_vamana_batched(data, r=24, ell=40, alpha=1.2,
                                               seed=0, device="cpu",
                                               timings=times)
    return adj_j, med_j, adj_t, med_t, times


def _check_adjacency(data, adj, r):
    n = len(data)
    assert adj.shape == (n, r)
    valid = adj >= 0
    assert np.all(adj[valid] < n)
    assert not np.any(adj == np.arange(n)[:, None])
    srt = np.sort(np.where(valid, adj, np.iinfo(np.int32).max), axis=1)
    assert not np.any((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
                      & (srt[:, 1:] < np.iinfo(np.int32).max))


def test_port_build_adjacency_and_medoid(data, builds):
    adj_j, med_j, adj_t, med_t, times = builds
    _check_adjacency(data, adj_t, 24)
    assert med_t == med_j
    s_t, s_j = tgraph.graph_stats(adj_t), jgraph.graph_stats(adj_j)
    assert s_t["max_degree"] <= 24 and s_t["min_degree"] >= 1
    assert abs(s_t["avg_degree"] - s_j["avg_degree"]) < 2.0, (s_t, s_j)
    assert set(times) == {"pass1_s", "pass2_s"}


def test_port_build_recall_matches_repro(data, builds):
    adj_j, med_j, adj_t, med_t, _ = builds
    rng = np.random.default_rng(2)
    queries = data[rng.integers(0, len(data), 32)] + \
        rng.normal(0, 0.05, (32, data.shape[1])).astype(np.float32)
    rec_j = jgraph.greedy_recall_at_k(data, adj_j, med_j, queries, ell=40)
    rec_t = jgraph.greedy_recall_at_k(data, adj_t, med_t, queries, ell=40)
    assert rec_t >= rec_j - 0.01, (rec_t, rec_j)
    # the port's own recall measure agrees with repro's on the same graph
    own = tgraph.greedy_recall_at_k(data, adj_t, med_t, queries, ell=40,
                                    device="cpu")
    assert abs(own - rec_t) <= 0.02, (own, rec_t)


def test_graph_entry_points_default_to_the_card(data, builds):
    """With no ``device`` the build and the recall measure run on the card,
    and raise where there is none rather than fall back to the CPU."""
    _, _, adj_t, med_t, _ = builds
    if torch.cuda.is_available():
        from repro_torch.device import resolve_device
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.build_vamana_batched(data[:64], r=8, ell=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.greedy_recall_at_k(data, adj_t, med_t, data[:4])


def test_robust_prune_batch_matches_repro(data):
    rng = np.random.default_rng(4)
    for alpha in (1.0, 1.2):
        p_ids = rng.integers(0, len(data), 8).astype(np.int32)
        cand = np.full((8, 48), -1, np.int32)
        for i in range(8):
            c = rng.choice(len(data), size=rng.integers(5, 48),
                           replace=False)
            c = np.unique(c[c != p_ids[i]])
            cand[i, :c.size] = c
        want = np.asarray(jgraph.robust_prune_batch(
            jnp.asarray(data), jnp.asarray(p_ids), jnp.asarray(cand), r=8,
            alpha=alpha))
        got = tgraph.robust_prune_batch(
            torch.from_numpy(data), torch.from_numpy(p_ids),
            torch.from_numpy(cand), r=8, alpha=alpha).numpy()
        np.testing.assert_array_equal(got, want)


def test_dedup_ascending_matches_repro():
    rng = np.random.default_rng(6)
    cands = rng.integers(-3, 40, (16, 30)).astype(np.int32)
    self_ids = rng.integers(0, 40, 16).astype(np.int32)
    want = np.asarray(jgraph._dedup_ascending(jnp.asarray(cands),
                                              jnp.asarray(self_ids)))
    got = tgraph._dedup_ascending(torch.from_numpy(cands),
                                  torch.from_numpy(self_ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_pairs_matches_repro():
    """Reverse-edge scatter: same adjacency, sorted pairs and overflow."""
    rng = np.random.default_rng(5)
    n, r = 60, 6
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.4] = -1
    adj_ext = np.concatenate([adj, np.full((1, r), -1, np.int32)])
    tgt = rng.integers(-1, n, 200).astype(np.int32)
    src = rng.integers(-1, n, 200).astype(np.int32)
    want = [np.asarray(x) for x in jgraph._scatter_pairs(
        jnp.asarray(adj_ext), jnp.asarray(tgt), jnp.asarray(src))]
    got = [x.numpy() for x in tgraph._scatter_pairs(
        torch.from_numpy(adj_ext.copy()), torch.from_numpy(tgt),
        torch.from_numpy(src))]
    assert want[3].any(), "the fixed inputs should overflow some targets"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_apply_pruned_rows_and_write_rows_match_repro():
    """The row set + reverse scatter of externally pruned rows, and the
    in-place row write, against repro's donated jitted versions."""
    rng = np.random.default_rng(9)
    n, r, b = 60, 6, 12
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.4] = -1
    adj_ext = np.concatenate([adj, np.full((1, r), -1, np.int32)])
    ids = rng.choice(n, b, replace=False).astype(np.int32)
    live = rng.random(b) < 0.8
    rows = rng.integers(-1, n, (b, r)).astype(np.int32)
    want = [np.asarray(x) for x in jgraph.apply_pruned_rows(
        jnp.asarray(adj_ext), jnp.asarray(ids), jnp.asarray(live),
        jnp.asarray(rows))]
    got = [x.numpy() for x in tgraph.apply_pruned_rows(
        torch.from_numpy(adj_ext.copy()), torch.from_numpy(ids),
        torch.from_numpy(live), torch.from_numpy(rows))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    buf = rng.normal(0, 1, (20, 3)).astype(np.float32)
    new = rng.normal(0, 1, (4, 3)).astype(np.float32)
    want = np.asarray(jgraph.write_rows(jnp.asarray(buf), jnp.asarray(new),
                                        7))
    t = torch.from_numpy(buf.copy())
    assert tgraph.write_rows(t, new, 7) is t           # in place
    np.testing.assert_array_equal(t.numpy(), want)


def test_incremental_builder_matches_repro(data, builds):
    """Two insert batches through both builders (capacity growth by
    max(cap + batch, 1.5 cap), then a steady-state batch): equal adjacency
    and capacity, contiguous ids."""
    adj_j, med_j, _, _, _ = builds
    n0 = 1200
    base, extra = data[:n0], data[n0:]
    # the first n0 nodes' rows, edges to later nodes dropped
    adj0 = np.where(adj_j[:n0] < n0, adj_j[:n0], -1).astype(np.int32)
    jb = jgraph.IncrementalBuilder(base, adj0, med_j % n0, ell=24,
                                   alpha=1.2, batch=128)
    tb = tgraph.IncrementalBuilder(base, adj0, med_j % n0, ell=24,
                                   alpha=1.2, batch=128, device="cpu")
    for chunk in (extra[:200], extra[200:260]):
        ids_j = jb.add_batch(chunk)
        ids_t = tb.add_batch(chunk)
        np.testing.assert_array_equal(ids_t, ids_j)
        assert tb.capacity == jb.capacity
        np.testing.assert_array_equal(tb.adjacency_device.numpy(),
                                      np.asarray(jb.adjacency_device))
        np.testing.assert_array_equal(tb.data_device.numpy(),
                                      np.asarray(jb.data_device))
    assert tb.capacity == max(n0 + 128, int(n0 * 1.5)) == 1800


def test_densify_2hop_matches_repro(builds):
    adj_j = builds[0]
    np.testing.assert_array_equal(tgraph.densify_2hop(adj_j, 100, seed=3),
                                  jgraph.densify_2hop(adj_j, 100, seed=3))


def test_separated_clusters_match_repro():
    """At d=192 the synthetic generator's clusters are far apart and
    within-cluster distances concentrate, so RobustPrune at α=1.2 keeps
    rows full of same-cluster neighbours and both builders lose the
    cross-cluster edges: the port reproduces the reference's (poor) graph —
    the same small share of nodes reachable from the medoid and the same
    greedy recall — rather than differing from it."""
    from repro_torch.data.synth import make_filtered_dataset
    ds = make_filtered_dataset(n=1500, d=192, n_queries=32, n_labels=20,
                               seed=0)
    x = ds.vectors
    adj_j, med_j = jgraph.build_vamana_batched(x, r=24, ell=40, alpha=1.2,
                                               seed=0)
    adj_t, med_t = tgraph.build_vamana_batched(x, r=24, ell=40, alpha=1.2,
                                               seed=0, device="cpu")
    reach_j = tgraph.reachable_fraction(adj_j, med_j)
    reach_t = tgraph.reachable_fraction(adj_t, med_t)
    assert reach_j < 0.1 and abs(reach_t - reach_j) <= 0.01, \
        (reach_t, reach_j)
    rec_j = jgraph.greedy_recall_at_k(x, adj_j, med_j, ds.queries, ell=40)
    rec_t = jgraph.greedy_recall_at_k(x, adj_t, med_t, ds.queries, ell=40)
    assert abs(rec_t - rec_j) <= 0.05, (rec_t, rec_j)


# ---------------------------------------------------------------------------
# The sequential reference builder and its navigator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_builds(data):
    adj_j, med_j = jgraph.build_vamana(data, r=24, ell=40, alpha=1.2,
                                       seed=0)
    adj_t, med_t = tgraph.build_vamana(data, r=24, ell=40, alpha=1.2,
                                       seed=0, device="cpu")
    return adj_j, med_j, adj_t, med_t


def test_robust_prune_matches_repro(data):
    """The numpy RobustPrune copy keeps the same ids in the same order on
    random candidate sets, at both passes' α and at r below and above the
    set size."""
    rng = np.random.default_rng(11)
    for alpha in (1.0, 1.2):
        for r in (4, 8, 64):
            for _ in range(6):
                p = int(rng.integers(0, len(data)))
                c = rng.choice(len(data), size=int(rng.integers(0, 60)),
                               replace=False)
                c = np.unique(c[c != p]).astype(np.int32)
                want = jgraph.robust_prune(data[p], c, data[c], r, alpha)
                got = tgraph.robust_prune(data[p], c, data[c], r, alpha)
                np.testing.assert_array_equal(got, want)


def test_reference_build_matches_repro(data, ref_builds):
    """``build_vamana(device="cpu")`` gives ``repro``'s reference graph:
    the same adjacency row for row and the same medoid."""
    adj_j, med_j, adj_t, med_t = ref_builds
    assert med_t == med_j
    _check_adjacency(data, adj_t, 24)
    bad = np.flatnonzero((adj_t != adj_j).any(1))
    assert bad.size == 0, (f"{bad.size} rows differ, first {bad[0]}: "
                           f"repro={adj_j[bad[0]]} port={adj_t[bad[0]]}")


def test_greedy_search_matches_repro(data, ref_builds):
    """The reference builder's navigator equals ``repro``'s greedy search
    on the reference graph: pools and their distances bit for bit."""
    adj_j, med_j, _, _ = ref_builds
    rng = np.random.default_rng(3)
    q = (data[rng.integers(0, len(data), 16)]
         + rng.normal(0, 0.05, (16, data.shape[1])).astype(np.float32))
    want_ids, want_d = jgraph.greedy_search(
        jnp.asarray(data), jnp.asarray(adj_j), med_j, jnp.asarray(q),
        ell=40, max_hops=200)
    got_ids, got_d = tgraph.greedy_search(
        torch.from_numpy(data), torch.from_numpy(adj_j), med_j,
        torch.from_numpy(q), ell=40, max_hops=200)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_incremental_builder_build_appends(data):
    """``IncrementalBuilder.build``, ``.adjacency`` and ``.data``, as
    tests/test_graph.py holds ``repro``'s: ids contiguous, the adjacency
    valid, inserted nodes wired in both directions and found by search."""
    b = tgraph.IncrementalBuilder.build(data[:1000], r=16, ell=32,
                                        alpha=1.2, seed=0, device="cpu")
    ids1 = b.add_batch(data[1000:1200])
    ids2 = b.add_batch(data[1200:1250])
    assert ids1.tolist() == list(range(1000, 1200))
    assert ids2.tolist() == list(range(1200, 1250))
    assert b.n == 1250
    np.testing.assert_array_equal(b.data, data[:1250])
    adj = b.adjacency
    _check_adjacency(data[:1250], adj, 16)
    new_deg = (adj[1000:] >= 0).sum(1)
    assert new_deg.mean() > 4
    assert np.isin(adj[:1000], np.arange(1000, 1250)).sum() > 0
    rng = np.random.default_rng(5)
    qidx = rng.integers(1000, 1250, 20)
    ids, _ = tgraph.greedy_search(torch.from_numpy(b.data),
                                  torch.from_numpy(adj), b.medoid,
                                  torch.from_numpy(data[qidx]), ell=32,
                                  max_hops=200)
    hits = sum(int(qidx[i]) in ids[i, :10].tolist() for i in range(20))
    assert hits >= 18, hits


def test_incremental_builder_build_rejects_bad_shape(data):
    b = tgraph.IncrementalBuilder.build(data[:500], r=16, ell=32, seed=0,
                                        device="cpu")
    with pytest.raises(ValueError):
        b.add_batch(np.zeros((3, 7), np.float32))
    assert b.add_batch(np.zeros((0, 24), np.float32)).size == 0
    assert b.adjacency.shape == (500, 16) and b.data.shape == (500, 24)


@pytest.fixture(scope="module")
def small_corpus():
    from repro.data.synth import make_filtered_dataset
    return make_filtered_dataset(n=600, d=24, n_queries=4, n_labels=12,
                                 seed=0)


def test_engine_reference_builder_matches_repro(small_corpus):
    """``FilteredANNEngine.build`` with ``IndexConfig(builder="reference")``
    builds ``repro``'s reference graph (adjacency and medoid); an unknown
    builder raises ``repro``'s ValueError."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    ds = small_corpus
    kw = dict(r=12, r_dense=48, l_build=24, pq_m=8)
    args = (ds.vectors, ds.label_offsets, ds.label_flat, ds.n_labels,
            ds.values)
    je = jeng.FilteredANNEngine.build(
        *args, jeng.IndexConfig(builder="reference", **kw))
    te = teng.FilteredANNEngine.build(
        *args, teng.IndexConfig(builder="reference", **kw), device="cpu")
    assert te.medoid == je.medoid
    np.testing.assert_array_equal(te.store.neighbors.numpy(),
                                  np.asarray(je.store.neighbors))
    assert "reference_s" in te.build_times
    with pytest.raises(ValueError, match="unknown builder 'bogus'"):
        teng.FilteredANNEngine.build(
            *args, teng.IndexConfig(builder="bogus", **kw), device="cpu")


def test_index_reference_builder_matches_repro(small_corpus):
    """``Index.build(config=IndexConfig(builder="reference"))`` in both
    packages: the same graph, the builder kept on the engine's config."""
    from repro import api as japi
    from repro_torch import api as tapi
    ds = small_corpus
    meta = ds.metadata()
    kw = dict(r=12, r_dense=48, l_build=24, pq_m=8, builder="reference")
    jidx = japi.Index.build(ds.vectors, meta, japi.IndexConfig(**kw))
    tidx = tapi.Index.build(ds.vectors, meta, tapi.IndexConfig(**kw),
                            device="cpu")
    assert tidx.engine.config.builder == "reference"
    assert tidx.engine.medoid == jidx.engine.medoid
    np.testing.assert_array_equal(tidx.engine.store.neighbors.numpy(),
                                  np.asarray(jidx.engine.store.neighbors))
    with pytest.raises(ValueError, match="unknown builder"):
        tapi.Index.build(ds.vectors[:32], meta[:32],
                         tapi.IndexConfig(builder="bogus"), device="cpu")

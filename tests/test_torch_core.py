"""Module-by-module parity of the PyTorch port's core against the JAX
package, on the shared_ds / shared_engine corpus of tests/conftest.py:
PQ tables and lookups bit for bit, encoding under ``repro``'s codebook, the
record store's first-occurrence mask and page counts, ``bloom_pass``, the
device membership predicates (``merged_table`` too), the
host planners' QueryFilters and the cost model's routes."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bloom as jbloom
from repro.core import cost_model as jcost
from repro.core import pq as jpq
from repro.core import records as jrecords
from repro.core import selectors as jsel
from repro.data.synth import make_selectors
from repro_torch.core import bloom as tbloom
from repro_torch.core import cost_model as tcost
from repro_torch.core import pq as tpq
from repro_torch.core import records as trecords
from repro_torch.core import selectors as tsel
from repro_torch.data.synth import make_filtered_dataset as t_make_dataset
from repro_torch.data.synth import make_selectors as t_make_selectors
from torch_port_helpers import port_engine

WORKLOADS = ("label", "label_and", "label_or", "range", "hybrid",
             "label_and_range")


@pytest.fixture(scope="module")
def port(shared_ds, shared_engine):
    return port_engine(shared_engine, shared_ds)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_dataset_same_stream(shared_ds):
    """The port's copy of the generator gives the same arrays."""
    t = t_make_dataset(n=6000, d=32, n_queries=24, n_labels=60, seed=0)
    for f in ("vectors", "label_offsets", "label_flat", "values", "queries",
              "query_ranges"):
        np.testing.assert_array_equal(getattr(t, f), getattr(shared_ds, f))
    assert t.query_labels == shared_ds.query_labels


def test_distance_table_bitwise(shared_ds, shared_engine, port):
    want = np.stack([np.asarray(jpq.distance_table(shared_engine.codebook,
                                                   jnp.asarray(q)))
                     for q in shared_ds.queries])
    got = tpq.distance_table(port.codebook,
                             torch.from_numpy(shared_ds.queries)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    one = tpq.distance_table(port.codebook,
                             torch.from_numpy(shared_ds.queries[0])).numpy()
    np.testing.assert_array_equal(_bits(one), _bits(want[0]))


def test_adc_lookup_bitwise(shared_ds, shared_engine, port):
    q = shared_ds.queries[3]
    table = jpq.distance_table(shared_engine.codebook, jnp.asarray(q))
    want = np.asarray(jpq.adc_lookup(shared_engine.codes, table))
    got = tpq.adc_lookup(port.codes, torch.from_numpy(np.array(table)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_encode_pq_with_repro_codebook(shared_ds, shared_engine, port):
    """Encoding under ``repro``'s codebook reproduces its codes."""
    got = tpq.encode_pq(port.codebook,
                        torch.from_numpy(shared_ds.vectors)).numpy()
    np.testing.assert_array_equal(got, np.asarray(shared_engine.codes))


def test_train_pq_quality(shared_ds, shared_engine):
    """The port's own k-means (other initial picks than jax.random) reaches
    the reference's quantization error within 5%."""
    x = torch.from_numpy(shared_ds.vectors)
    cb = tpq.train_pq(x, 8, iters=8, seed=0)
    err_t = float(((tpq.decode_pq(cb, tpq.encode_pq(cb, x)) - x) ** 2)
                  .sum(1).mean())
    xj = jnp.asarray(shared_ds.vectors)
    dec = jpq.decode_pq(shared_engine.codebook, shared_engine.codes)
    err_j = float(jnp.mean(jnp.sum((dec - xj) ** 2, axis=1)))
    assert err_t <= 1.05 * err_j, (err_t, err_j)


def test_candidate_first_mask(shared_engine, port):
    want = jrecords.candidate_first_mask(
        np.asarray(shared_engine.store.neighbors),
        np.asarray(shared_engine.store.dense_neighbors))
    got = trecords.candidate_first_mask(port.store.neighbors,
                                        port.store.dense_neighbors)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.store.cand_first.numpy(),
                                  np.asarray(shared_engine.store.cand_first))
    assert port.store.pages_std == shared_engine.store.pages_std
    assert port.store.pages_dense == shared_engine.store.pages_dense


@pytest.mark.parametrize("vec_dtype_size", [2, 4, 1])
def test_make_record_store_page_counts(shared_engine, vec_dtype_size):
    """``vec_dtype_size`` sets the page counts as in ``repro``, while the
    vectors stay float32."""
    s = shared_engine.store
    arrays = [np.asarray(a) for a in (s.vectors, s.neighbors,
                                      s.dense_neighbors, s.rec_labels,
                                      s.rec_values)]
    want = jrecords.make_record_store(*arrays, vec_dtype_size=vec_dtype_size)
    got = trecords.make_record_store(*arrays, "cpu",
                                     vec_dtype_size=vec_dtype_size)
    assert (got.pages_std, got.pages_dense) == (want.pages_std,
                                                want.pages_dense)
    assert got.vectors.dtype == torch.float32
    np.testing.assert_array_equal(got.cand_first.numpy(),
                                  np.asarray(want.cand_first))


@pytest.mark.parametrize("mask", [0, 0x5, 0x80000001, 0xFFFFFFFF])
def test_bloom_pass_equal(shared_engine, port, mask):
    """On the uint32 words (numpy) and on the port's int32 tensor view,
    against ``repro``'s jitted probe, scalar and per-row masks."""
    blooms = np.asarray(shared_engine.mem.blooms)
    want = np.asarray(jbloom.bloom_pass(jnp.asarray(blooms),
                                        np.uint32(mask)))
    np.testing.assert_array_equal(tbloom.bloom_pass(blooms, mask), want)
    np.testing.assert_array_equal(
        tbloom.bloom_pass(port.mem.blooms, mask).numpy(), want)
    rows = np.random.default_rng(mask & 0xFF).integers(
        0, 2 ** 32, blooms.shape, dtype=np.uint64).astype(np.uint32) & mask
    want = np.asarray(jbloom.bloom_pass(jnp.asarray(blooms),
                                        jnp.asarray(rows)))
    np.testing.assert_array_equal(
        tbloom.bloom_pass(port.mem.blooms, rows).numpy(), want)


def _plans(ds, e, pe, workload):
    cfg = e.config
    sels = make_selectors(ds, e, workload)
    tsels = t_make_selectors(ds, pe, workload)
    return ([s.plan(cfg.ql, cfg.cap, cfg.qr) for s in sels],
            [s.plan(cfg.ql, cfg.cap, cfg.qr) for s in tsels])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_selector_plans_equal(shared_ds, shared_engine, port, workload):
    jp, tp = _plans(shared_ds, shared_engine, port, workload)
    for a, b in zip(jp, tp):
        for f in jsel.QueryFilter._fields:
            x, y = np.asarray(getattr(a.qfilter, f)), getattr(b.qfilter, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(y, x, err_msg=f)
        for f in ("selectivity", "precision_in", "precision_pre",
                  "pages_prefetch", "pages_prescan", "force_mech"):
            assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("workload", WORKLOADS)
def test_membership_equal(shared_ds, shared_engine, port, workload):
    """is_member_approx / is_member / merged_table_words on random ids."""
    e = shared_engine
    jp, tp = _plans(shared_ds, e, port, workload)
    jqf = jsel.stack_filters([p.qfilter for p in jp])
    tqf = tsel.filter_to_device(tsel.stack_filters([p.qfilter for p in tp]),
                                "cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, e.n, (len(jp), 300)).astype(np.int32)
    want = np.asarray(jax.vmap(jsel.is_member_approx, in_axes=(0, 0, None))(
        jqf, jnp.asarray(ids), e.mem))
    got = tsel.is_member_approx(tqf, torch.from_numpy(ids), port.mem)
    np.testing.assert_array_equal(got.numpy(), want)

    rl = np.asarray(e.store.rec_labels)[ids]
    rv = np.asarray(e.store.rec_values)[ids]
    want = np.asarray(jax.vmap(jsel.is_member)(jqf, jnp.asarray(rl),
                                               jnp.asarray(rv)))
    got = tsel.is_member(tqf, torch.from_numpy(rl), torch.from_numpy(rv))
    np.testing.assert_array_equal(got.numpy(), want)

    want = np.asarray(jsel.merged_table_words(
        jax.tree_util.tree_map(jnp.asarray, jqf), e.n))
    got = tsel.merged_table_words(tqf, e.n)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jsel.merged_table(
        jax.tree_util.tree_map(jnp.asarray, jqf), e.n))
    got = tsel.merged_table(tqf, e.n)
    assert got.dtype == torch.bool and got.shape == (len(jp), e.n + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.vmap(jsel.merged_membership)(jqf, jnp.asarray(ids)))
    got = tsel.merged_membership(tqf, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_params_equal(shared_ds, shared_engine, port):
    jp, tp = _plans(shared_ds, shared_engine, port, "hybrid")
    jqf = jsel.stack_filters([p.qfilter for p in jp])
    tqf = tsel.filter_to_device(tsel.stack_filters([p.qfilter for p in tp]),
                                "cpu")
    for a, b in zip(jsel.kernel_filter_params(jqf),
                    tsel.kernel_filter_params(tqf)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jsel.kernel_view(shared_engine.mem),
                    tsel.kernel_view(port.mem)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("workload", ("label", "range", "hybrid"))
def test_route_query_equal(shared_ds, shared_engine, port, workload):
    jp, tp = _plans(shared_ds, shared_engine, port, workload)
    for a, b in zip(jp, tp):
        kw = dict(n=6000, l=32, s=a.selectivity, p_pre=a.precision_pre,
                  p_in=a.precision_in, x_pre=a.pages_prescan,
                  x_in=a.pages_prefetch, r=24, r_d=264, s_r=1, s_d=2)
        ra = jcost.route_query(jcost.CostInputs(**kw), 10.0, 1.0, 1024)
        rb = tcost.route_query(tcost.CostInputs(**kw), 10.0, 1.0, 1024)
        assert (ra.mechanism, ra.effective_l) == (rb.mechanism,
                                                  rb.effective_l)
        for m in ("pre", "in", "post"):
            assert ra.costs[m].io_pages == rb.costs[m].io_pages
            assert ra.costs[m].compute == rb.costs[m].compute

"""The disk tier of the PyTorch port (``repro_torch.storage``) against the
JAX package's (``repro.storage``) and against the port's device backend,
on tests/test_storage.py's corpus (N=600, D=24, 8 categories).

One ``repro`` Index is built per module and handed to the port through
``torch_port_helpers.port_index``; slabs are spilled once from each
package. The property throughout is that of tests/test_storage.py: the
disk backend is an I/O path, never a result path — every disk
configuration here (cache size, read-ahead depth, fault plan, eviction
pressure) answers per request with the device backend's ids, distances
and integer counters exactly. Against ``repro`` the slab bytes and meta
are equal, the fault draws are equal, and the same batch gives the same
ids, integer counters and disk-tier counters (distances within 1e-6).
"""
import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as japi
from repro.core import faults as jfaults
from repro.storage import DiskRecordStore as JDiskRecordStore
from repro.storage import PageCache as JPageCache
from repro.storage import slab as jslab
from repro_torch import api as tapi
from repro_torch.ckpt.checkpoint import CheckpointCorruptionError
from repro_torch.core import faults as tfaults
from repro_torch.core import search as tsearch
from repro_torch.core.faults import FaultPlan
from repro_torch.core.io_sim import IOModel
from repro_torch.storage import (DiskRecordStore, PageCache, SlabLayout,
                                 StorageConfig)
from repro_torch.storage import slab as slab_mod
from torch_port_helpers import _port_config, port_index

POLICIES = ("strict_in", "post", "speculative", "strict_pre")
INT_STATS = ("io_pages", "hops", "explored", "fp_explored", "n_valid",
             "dist_comps", "faults", "retries", "degraded")
# the disk counters that do not depend on the clock
DISK_INTS = ("pages_read", "preads", "records_fetched", "attr_probes",
             "attr_reads", "gated_skips", "readahead_pages", "faults",
             "retries", "degraded", "hits", "misses", "evictions",
             "readahead_hits")

N = 600
DIM = 24


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """Drop the XLA executables of earlier suites in this worker before the
    JAX package compiles its search with an embedded ``io_callback``
    (tests/test_storage.py does the same, for the same reason)."""
    import gc
    import jax
    jax.clear_caches()
    gc.collect()


# ---------------------------------------------------------------------------
# Unit: slab codec, page cache, calibration, fault draws (no index)
# ---------------------------------------------------------------------------

def _slab_fields(rng, lo, m=None):
    shape = () if m is None else (m,)
    return (rng.normal(0, 1, shape + (lo.dim,)).astype(np.float32),
            rng.integers(-1, 500, shape + (lo.r,)).astype(np.int32),
            rng.integers(-1, 500, shape + (lo.r_dense,)).astype(np.int32),
            rng.integers(-1, 60, shape + (lo.max_labels,)).astype(np.int32),
            rng.uniform(0, 1, shape + (lo.n_fields,)).astype(np.float32),
            rng.integers(0, 2, shape + (lo.r + lo.r_dense,)).astype(bool))


def test_slab_roundtrip_and_crc():
    rng = np.random.default_rng(0)
    lo = SlabLayout(dim=48, r=16, r_dense=100, max_labels=8, n_fields=2)
    vec, nbrs, dense, labels, values, cf = _slab_fields(rng, lo)
    blob = slab_mod.encode_slabs(
        lo, *(f[None] for f in (vec, nbrs, dense, labels, values,
                                cf)))[0].tobytes()
    assert len(blob) == lo.slab_bytes and lo.slab_bytes % lo.page_bytes == 0
    # byte-equal to the JAX package's codec
    jlo = jslab.SlabLayout(48, 16, 100, 8, 2)
    assert blob == jslab.encode_slab(jlo, vec, nbrs, dense, labels, values,
                                     cf)

    rec = slab_mod.decode_std(lo, blob[:lo.std_bytes])
    np.testing.assert_array_equal(rec["vector"], vec)
    np.testing.assert_array_equal(rec["neighbors"], nbrs)
    np.testing.assert_array_equal(rec["rec_labels"], labels)
    np.testing.assert_array_equal(rec["rec_values"], values)
    np.testing.assert_array_equal(rec["cand_first"], cf)
    np.testing.assert_array_equal(
        slab_mod.decode_dense(lo, blob[lo.std_bytes:]), dense)

    # an attribute probe decodes from the std block's final page alone
    pg = blob[lo.attr_page * lo.page_bytes:(lo.attr_page + 1) * lo.page_bytes]
    attrs = slab_mod.decode_attrs(lo, pg)
    np.testing.assert_array_equal(attrs["rec_labels"], labels)
    np.testing.assert_array_equal(attrs["rec_values"], values)

    # a bit flip in any region is a detected checksum failure, on every path
    for off in (0, lo.tail_off + 3):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        with pytest.raises(slab_mod.SlabChecksumError):
            slab_mod.decode_std(lo, bytes(bad[:lo.std_bytes]))
    bad = bytearray(blob)
    bad[lo.std_bytes] ^= 0xFF
    with pytest.raises(slab_mod.SlabChecksumError):
        slab_mod.decode_dense(lo, bytes(bad[lo.std_bytes:]))
    bad = bytearray(pg)
    bad[lo.tail_off - lo.attr_page * lo.page_bytes] ^= 0xFF
    with pytest.raises(slab_mod.SlabChecksumError):
        slab_mod.decode_attrs(lo, bytes(bad))


@pytest.mark.parametrize("widths", [(48, 16, 100, 8, 2), (24, 12, 60, 8, 1),
                                    (192, 32, 480, 16, 1), (8, 4, 0, 3, 0),
                                    (128, 64, 500, 16, 4)])
def test_slab_block_encoder_byte_equal(widths):
    """``encode_slabs`` (the block encoder of ``write_slab_file``) equals
    ``repro``'s record-by-record ``encode_slab`` row for row, and the
    layouts agree, the full-size one (d=192, R=32, R_d=480) included."""
    rng = np.random.default_rng(sum(widths))
    lo, jlo = SlabLayout(*widths), jslab.SlabLayout(*widths)
    assert lo.to_json() == jlo.to_json()
    for f in ("std_pages", "slab_pages", "tail_off", "attr_page",
              "tail_bytes"):
        assert getattr(lo, f) == getattr(jlo, f), f
    assert lo.tail_bytes <= lo.page_bytes
    assert lo.slab_pages == lo.std_pages + lo.dense_pages
    assert SlabLayout.from_json(lo.to_json()).slab_bytes == lo.slab_bytes
    fields = _slab_fields(rng, lo, m=37)
    blk = slab_mod.encode_slabs(lo, *fields)
    assert blk.shape == (37, lo.slab_bytes)
    for i in range(37):
        assert blk[i].tobytes() == jslab.encode_slab(
            jlo, *(f[i] for f in fields)), i


def _cache_ops(c):
    """tests/test_storage.py's clock scenario; returns what it observed."""
    seen = []
    for pid in range(4):
        c.put(pid, bytes([pid]))
    seen.append(c.get(1))
    c.put(4, b"\x04")
    seen += [c.evictions, c.contains(0), c.contains(1), c.get(0)]
    seen.append(dict(c.counters()))
    c.get(1)
    c.put(5, b"\x05")
    seen += [c.contains(1), c.evictions]
    c.put(7, b"\x07", readahead=True)
    seen.append(c.readahead_hits)
    c.get(7)
    c.get(7)
    seen.append(c.readahead_hits)
    before = len(c)
    c.invalidate([1, 7])
    seen += [c.contains(1), c.contains(7), before - len(c)]
    for pid in range(10, 20):
        c.put(pid, b"x")
    seen += [len(c), c.contains(19), sorted(c._frames), dict(c.counters())]
    return seen


def test_page_cache_clock_eviction_and_counters():
    seen = _cache_ops(PageCache(4))
    assert seen[0] == b"\x01"
    # every fresh frame gets one second chance: the sweep clears all four
    # ref bits, wraps, and evicts the oldest (0)
    assert seen[1:5] == [1, False, True, None]
    assert seen[5]["hits"] == 1 and seen[5]["misses"] == 1
    assert seen[5]["resident_pages"] == 4 and seen[5]["capacity_pages"] == 4
    # a re-referenced frame (1) survives the next eviction
    assert seen[6:8] == [True, 2]
    # read-ahead provenance: only the first demand hit counts
    assert seen[8:10] == [0, 1]
    assert seen[10:13] == [False, False, 2]
    assert seen[13] <= 4 and seen[14]
    # the same operations on repro's cache: the same eviction order, frames
    # and counters
    assert seen == _cache_ops(JPageCache(4))


def test_calibrate_from_samples_recovers_synthetic_device():
    t_page, par = 80.0, 8
    serial = [{"pages": p, "us": p * t_page, "kind": "serial"}
              for p in (1, 1, 2, 3, 1)]
    batch = [{"pages": p, "us": -(-p // par) * t_page, "kind": "batch"}
             for p in (8, 16, 24, 64, 128, 40)]
    m = IOModel.calibrate_from_samples(serial + batch)
    assert m.t_page_us == pytest.approx(t_page)
    assert m.parallelism == par
    noisy = serial + [{"pages": 1, "us": 50000.0, "kind": "serial"}]
    assert IOModel.calibrate_from_samples(noisy).t_page_us == \
        pytest.approx(t_page)
    m0 = IOModel.calibrate_from_samples([])
    assert m0.t_page_us == IOModel.t_page_us
    assert m0.parallelism == IOModel.parallelism


def test_prefetch_depth_validation():
    tsearch.SearchParams(l_search=16, prefetch_depth=4)
    with pytest.raises(AssertionError, match="prefetch_depth"):
        tsearch.SearchParams(l_search=16,
                             prefetch_depth=IOModel.parallelism + 1)
    with pytest.raises(AssertionError, match="prefetch_depth"):
        tsearch.SearchParams(l_search=16, prefetch_depth=0)
    assert tapi.SearchRequest(query=np.zeros(4, np.float32),
                              prefetch_depth=3).overrides()[
                                  "prefetch_depth"] == 3


@pytest.mark.parametrize("plan", [
    FaultPlan(read_fail_rate=0.2, corrupt_rate=0.1, seed=11),
    FaultPlan(read_fail_rate=0.7, seed=3, max_retries=1, hedge=False),
    FaultPlan(read_fail_rate=1e-7, corrupt_rate=0.999, seed=2 ** 31 - 1)])
def test_fault_draw_twins_bit_identical(plan):
    """The numpy twins equal the port's tensor draws and ``repro``'s twins
    (ids up to 2**31 - 1 and hop counters past 2**16 cross the uint32
    wraparound of every product)."""
    ids = np.concatenate([np.arange(4096),
                          np.array([2 ** 31 - 1, 2 ** 24 + 3, 99991])])
    hops = (ids * 7) % 70001
    jplan = jfaults.FaultPlan(**dataclasses.asdict(plan))
    for a in range(plan.attempts):
        host = tfaults.read_attempt_bad_np(ids, hops, a, plan)
        dev = tfaults.read_attempt_bad(torch.from_numpy(ids),
                                       torch.from_numpy(hops), a, plan)
        np.testing.assert_array_equal(dev.numpy(), host)
        np.testing.assert_array_equal(
            jfaults.read_attempt_bad_np(ids, hops, a, jplan), host)
        np.testing.assert_array_equal(
            tfaults.read_fail_np(ids, hops, a, plan),
            jfaults.read_fail_np(ids, hops, a, jplan))
        np.testing.assert_array_equal(
            tfaults.read_corrupt_np(ids, hops, a, plan),
            jfaults.read_corrupt_np(ids, hops, a, jplan))
    np.testing.assert_array_equal(
        tfaults._uniform_np(ids, hops, plan.seed, 1, 0),
        np.asarray(jfaults._uniform(jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(hops, jnp.int32),
                                    plan.seed, 1, 0)))


# ---------------------------------------------------------------------------
# Integration: disk backend vs device backend, and against repro
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    """tests/test_storage.py's corpus."""
    rng = np.random.default_rng(7)
    vectors = rng.normal(0, 1, (N, DIM)).astype(np.float32)
    metadata = [{"cat": sorted(set(int(x) for x in
                               rng.integers(0, 8, rng.integers(1, 4)))),
                 "value": float(v)}
                for v in rng.uniform(0, 100, N)]
    return vectors, metadata


CFG = japi.IndexConfig(r=12, r_dense=60, l_build=24, pq_m=8)
DEFAULTS = japi.SearchConfig(k=5, l=16, max_hops=60)


@pytest.fixture(scope="module")
def pair(corpus):
    """(repro Index, port Index) over the same graph, both on the device
    backend."""
    vectors, metadata = corpus
    jidx = japi.Index.build(vectors, metadata, CFG, defaults=DEFAULTS)
    return jidx, port_index(jidx)


@pytest.fixture(scope="module")
def slab_dir(tmp_path_factory, pair):
    """The port's slabs, spilled once from its engine."""
    _, tidx = pair
    path = str(tmp_path_factory.mktemp("tslabs"))
    DiskRecordStore.from_record_store(path, tidx.engine.store,
                                      n=tidx.engine.n).close()
    return path


@pytest.fixture(scope="module")
def jslab_dir(tmp_path_factory, pair):
    """``repro``'s slabs, spilled once from its engine."""
    jidx, _ = pair
    path = str(tmp_path_factory.mktemp("jslabs"))
    JDiskRecordStore.from_record_store(path, jidx.engine.store,
                                       n=jidx.engine.n).close()
    return path


def _filter(api, i):
    """A label, a range and a hybrid filter in turn: at this size the
    speculative router sends the first to the pre route and the others to
    speculative in-filtering."""
    tag, num = api.Tag("cat"), api.Num("value")
    return (tag == 2, num < 50.0, (tag == 2) | (num < 60.0))[i % 3]


def _requests(api, vectors, n=6, policies=POLICIES):
    return [api.SearchRequest(query=vectors[i] + 0.01,
                              filter=_filter(api, i), policy=pol)
            for i in range(n) for pol in policies]


def _disk_twin(idx, path, config=None, jax_side=False):
    """A disk-backend clone of ``idx`` sharing its graph and PQ state:
    only the record tier differs, which is what is under test."""
    twin = copy.copy(idx)
    twin.engine = copy.copy(idx.engine)
    cls = JDiskRecordStore if jax_side else DiskRecordStore
    if config is not None and jax_side:
        from repro.storage import StorageConfig as JStorageConfig
        config = JStorageConfig(**dataclasses.asdict(config))
    twin.engine.attach_disk_store(cls(path) if config is None
                                  else cls(path, config))
    return twin


def _with_defaults(idx, scfg):
    out = copy.copy(idx)
    out.defaults = scfg
    return out


def _assert_identical(res_a, res_b, tag=""):
    """Port against port: ids, distances and integer counters exactly."""
    for i, (a, b) in enumerate(zip(res_a, res_b)):
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{tag} #{i}")
        np.testing.assert_array_equal(a.dists, b.dists, err_msg=f"{tag} #{i}")
        assert a.stats.mechanism == b.stats.mechanism, f"{tag} #{i}"
        for f in INT_STATS:
            assert getattr(a.stats, f) == getattr(b.stats, f), \
                f"{tag} #{i}: {f}"


def _assert_like_repro(jres, tres, tag=""):
    """Port against repro: ids and integer counters exactly, distances
    within 1e-6."""
    for i, (a, b) in enumerate(zip(jres, tres)):
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=f"{tag} #{i}")
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{tag} #{i}")
        assert b.stats.mechanism == a.stats.mechanism, f"{tag} #{i}"
        for f in INT_STATS:
            assert getattr(b.stats, f) == getattr(a.stats, f), \
                f"{tag} #{i}: {f}"


WALL_KEYS = {"fetch_us", "pread_us"}    # the port's host clocks


def _disk_ints(snap):
    return {k: int(snap[k]) for k in DISK_INTS}


def test_slab_files_byte_equal_to_repro(pair, slab_dir, jslab_dir):
    """The same engine state spills to the same slab file and meta JSON in
    both packages."""
    for fn in (slab_mod.SLAB_FILE, slab_mod.META_FILE):
        with open(os.path.join(slab_dir, fn), "rb") as a, \
                open(os.path.join(jslab_dir, fn), "rb") as b:
            assert a.read() == b.read(), fn
    meta = slab_mod.read_meta(slab_dir)
    assert meta["n"] == N and meta["file_bytes"] == os.path.getsize(
        os.path.join(slab_dir, slab_mod.SLAB_FILE))


@pytest.mark.parametrize("track", [False, True])
def test_read_vectors_equal_to_repro(pair, slab_dir, jslab_dir, track):
    """``read_vectors`` on either package's slab returns ``repro``'s
    vectors; untracked reads leave the fetch counters alone."""
    jidx, _ = pair
    ids = np.random.default_rng(3).integers(0, N, 40)
    ds = DiskRecordStore(slab_dir)
    js = JDiskRecordStore(jslab_dir)
    try:
        want = js.read_vectors(ids, track=track)
        np.testing.assert_array_equal(ds.read_vectors(ids, track=track),
                                      want)
        np.testing.assert_array_equal(
            want, np.asarray(jidx.engine.store.vectors)[ids])
        assert ds.counters.records_fetched == \
            js.counters.records_fetched == (len(ids) if track else 0)
        assert ds.counters.pages_read == js.counters.pages_read
    finally:
        ds.close()
        js.close()


def test_disk_bit_identical_across_policies(corpus, pair, slab_dir,
                                            jslab_dir):
    vectors, _ = corpus
    jidx, tidx = pair
    reqs = _requests(tapi, vectors)
    dsk = _disk_twin(tidx, slab_dir)
    want = tidx.search_batch(reqs, with_metadata=False)
    got = dsk.search_batch(reqs, with_metadata=False)
    _assert_identical(want, got, "device vs disk")
    # the batch covers the pre route, speculative in-filtering, strict
    # in-filtering and post-filtering
    routes = {(r.policy, g.stats.mechanism) for r, g in zip(reqs, got)}
    assert {("strict_pre", "pre"), ("strict_in", "in"),
            ("post", "post")} <= routes
    assert ("speculative", "in") in routes, routes
    snap = dsk.engine.disk_store.snapshot()
    assert snap["pages_read"] > 0 and snap["records_fetched"] > 0
    assert snap["n_samples"] > 0 and snap["p50_page_us"] > 0.0
    # and against repro's disk backend on the same batch: the same answers
    # and the same disk-tier counters
    jdsk = _disk_twin(jidx, jslab_dir, jax_side=True)
    jgot = jdsk.search_batch(_requests(japi, vectors), with_metadata=False)
    _assert_like_repro(jgot, got, "repro disk vs port disk")
    assert _disk_ints(jdsk.engine.disk_store.snapshot()) == _disk_ints(snap)


def test_eviction_order_never_changes_results(corpus, pair, slab_dir):
    """Cache capacity from eviction-heavy to all-resident: the answers and
    counters are the device backend's throughout (the cache is
    transparent)."""
    vectors, _ = corpus
    _, tidx = pair
    reqs = _requests(tapi, vectors, n=4, policies=("strict_in", "post"))
    want = tidx.search_batch(reqs, with_metadata=False)
    evictions = []
    for cap in (8, 64, 1 << 20):
        dsk = _disk_twin(tidx, slab_dir, StorageConfig(cache_pages=cap))
        _assert_identical(want, dsk.search_batch(reqs, with_metadata=False),
                          f"cache_pages={cap}")
        evictions.append(dsk.engine.disk_store.snapshot()["evictions"])
    assert evictions[0] > 0          # the tiny cache really thrashed
    assert evictions[-1] == 0        # the big one held everything


def test_bloom_gated_attr_reads_skip_pages(corpus, pair, slab_dir):
    vectors, _ = corpus
    _, tidx = pair
    reqs = _requests(tapi, vectors, n=6, policies=("strict_in",))
    dsk = _disk_twin(tidx, slab_dir)
    _assert_identical(tidx.search_batch(reqs, with_metadata=False),
                      dsk.search_batch(reqs, with_metadata=False), "strict")
    snap = dsk.engine.disk_store.snapshot()
    assert snap["attr_probes"] > 0
    assert snap["gated_skips"] > 0                     # pages actually saved
    assert snap["attr_reads"] + snap["gated_skips"] == snap["attr_probes"]


def test_readahead_depth_changes_io_not_results(corpus, pair, slab_dir):
    vectors, _ = corpus
    _, tidx = pair
    want = tidx.search_batch(_requests(tapi, vectors, n=4),
                             with_metadata=False)
    snaps = {}
    for depth in (1, 3):
        reqs = [dataclasses.replace(r, prefetch_depth=depth)
                for r in _requests(tapi, vectors, n=4)]
        dsk = _disk_twin(tidx, slab_dir)
        _assert_identical(want, dsk.search_batch(reqs, with_metadata=False),
                          f"depth={depth}")
        snaps[depth] = dsk.engine.disk_store.snapshot()
    assert snaps[1]["readahead_pages"] == 0
    assert snaps[3]["readahead_pages"] > 0
    assert snaps[3]["readahead_hits"] > 0    # the warmed pages got used


def _faulted(tidx, jidx, slab_dir, jslab_dir, plan, reqs_of):
    """The plan's batch on the port's device and disk backends and on
    repro's disk backend."""
    scfg = dataclasses.replace(tidx.defaults, fault_plan=plan)
    jscfg = dataclasses.replace(
        jidx.defaults,
        fault_plan=jfaults.FaultPlan(**dataclasses.asdict(plan)))
    rm = _with_defaults(tidx, scfg).search_batch(reqs_of(tapi),
                                                 with_metadata=False)
    dsk = _with_defaults(_disk_twin(tidx, slab_dir), scfg)
    rd = dsk.search_batch(reqs_of(tapi), with_metadata=False)
    jdsk = _with_defaults(_disk_twin(jidx, jslab_dir, jax_side=True), jscfg)
    rj = jdsk.search_batch(reqs_of(japi), with_metadata=False)
    _assert_identical(rm, rd, "device vs disk under faults")
    _assert_like_repro(rj, rd, "repro disk vs port disk under faults")
    snap = dsk.engine.disk_store.snapshot()
    assert _disk_ints(jdsk.engine.disk_store.snapshot()) == _disk_ints(snap)
    return rd, snap


def test_fault_plan_routes_through_real_reads(corpus, pair, slab_dir,
                                              jslab_dir):
    """Same plan, both backends: identical results AND identical ladder
    accounting — the disk tier's real IOError/CRC failures follow the hop
    step's retry→hedge→degrade ladder draw for draw."""
    vectors, _ = corpus
    jidx, tidx = pair
    plan = FaultPlan(read_fail_rate=0.08, corrupt_rate=0.04, seed=11)
    rd, snap = _faulted(tidx, jidx, slab_dir, jslab_dir, plan,
                        lambda api: _requests(
                            api, vectors, n=4,
                            policies=("strict_in", "post", "speculative")))
    assert snap["faults"] > 0 and snap["retries"] > 0
    # moderate rates: the ladder always recovered
    assert snap["degraded"] == 0
    assert all(r.stats.degraded == 0 for r in rd)
    assert sum(r.stats.faults for r in rd) > 0


def test_ladder_exhaustion_degrades_identically(corpus, pair, slab_dir,
                                                jslab_dir):
    vectors, _ = corpus
    jidx, tidx = pair
    plan = FaultPlan(read_fail_rate=0.7, seed=3, max_retries=1, hedge=False)
    rd, snap = _faulted(tidx, jidx, slab_dir, jslab_dir, plan,
                        lambda api: _requests(
                            api, vectors, n=3,
                            policies=("strict_in", "post")))
    assert snap["degraded"] > 0
    # (the store counts a row each time it is read, and the driver re-reads
    # a frontier at each chunk start, so its count is the larger)
    assert 0 < sum(r.stats.degraded for r in rd) <= snap["degraded"]


def test_query_stats_and_session_surface_disk_counters(corpus, pair,
                                                       slab_dir, jslab_dir):
    """``QueryStats.disk`` and ``Session.disk_stats`` carry ``repro``'s
    keys, and on the same batch the same counts."""
    vectors, _ = corpus
    jidx, tidx = pair
    dsk = _disk_twin(tidx, slab_dir)
    jdsk = _disk_twin(jidx, jslab_dir, jax_side=True)
    _, stats = dsk.search_batch(_requests(tapi, vectors, n=2),
                                with_stats=True, with_metadata=False)
    _, jstats = jdsk.search_batch(_requests(japi, vectors, n=2),
                                  with_stats=True, with_metadata=False)
    # the port's delta has no p50_page_us (the p50 of the store's first
    # reads, not of the delta's interval); its host clocks are its own
    assert stats.disk is not None
    assert set(stats.disk) - WALL_KEYS == set(jstats.disk) - {"p50_page_us"}
    assert stats.disk["pages_read"] >= 0 and "hit_rate" in stats.disk
    assert {k: stats.disk[k] for k in stats.disk if k not in WALL_KEYS} == \
        {k: jstats.disk[k] for k in jstats.disk if k != "p50_page_us"}
    # the device backend reports no disk block
    _, stats_m = tidx.search_batch(_requests(tapi, vectors, n=2),
                                   with_stats=True, with_metadata=False)
    assert stats_m.disk is None

    snaps = []
    for api, idx in ((tapi, dsk), (japi, jdsk)):
        with api.Session(idx, api.SessionConfig(max_batch=4)) as s:
            h = s.submit(api.SearchRequest(query=vectors[0],
                                           filter=(api.Tag("cat") == 2)))
            h.result()
            snaps.append(s.disk_stats())
    assert snaps[0]["records_fetched"] > 0
    assert set(snaps[0]) - WALL_KEYS == set(snaps[1])
    assert _disk_ints(snaps[0]) == _disk_ints(snaps[1])
    assert tapi.Session(tidx).disk_stats() is None


def test_scan_rung_disk_equals_device(corpus, pair, slab_dir, jslab_dir):
    """``approx_scan_batch`` (the last degrade rung) on the disk backend:
    the device backend's answers, ``repro``'s disk counters."""
    vectors, _ = corpus
    jidx, tidx = pair
    reqs = _requests(tapi, vectors, n=4, policies=("speculative",))
    want, _ = tidx.approx_scan_batch(reqs, with_stats=True,
                                     with_metadata=False)
    dsk = _disk_twin(tidx, slab_dir)
    got, stats = dsk.approx_scan_batch(reqs, with_stats=True,
                                       with_metadata=False)
    _assert_identical(want, got, "scan rung")
    assert stats.mechanism == ["scan"] * len(reqs)
    assert stats.disk["records_fetched"] > 0
    jdsk = _disk_twin(jidx, jslab_dir, jax_side=True)
    jgot, jstats = jdsk.approx_scan_batch(
        _requests(japi, vectors, n=4, policies=("speculative",)),
        with_stats=True, with_metadata=False)
    _assert_like_repro(jgot, got, "scan rung, repro disk vs port disk")
    assert _disk_ints(jstats.disk) == _disk_ints(stats.disk)


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_pipelined_disk_search_equals_single_shot(corpus, pair, slab_dir,
                                                  mode):
    """The search drivers with the disk tier's fetch callable: the
    pipelined driver (compaction, one chunk late) and the single-shot
    search give the device backend's results field for field."""
    vectors, _ = corpus
    _, tidx = pair
    e = tidx.engine
    sels = [tidx.compile_filter(tapi.Tag("cat") == c % 8) for c in range(12)]
    cfg = e.config
    from repro_torch.core.selectors import stack_filters
    qf = stack_filters([s.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
                        for s in sels])
    q = vectors[:12] + 0.01
    sp = tsearch.SearchParams(l_search=32, k=5, max_hops=60, l_valid=16,
                              mode=mode)
    ds = DiskRecordStore(slab_dir)
    stub = ds.stub_store()
    want = tsearch.filtered_search(e.store, e.codes, e.codebook, e.mem, qf,
                                   q, e.medoid, sp)
    for got in (tsearch.filtered_search(stub, e.codes, e.codebook, e.mem,
                                        qf, q, e.medoid, sp,
                                        fetch_fn=ds.fetch_callable),
                tsearch.filtered_search_pipelined(
                    stub, e.codes, e.codebook, e.mem, qf, q, e.medoid, sp,
                    hop_chunk=4, fetch_fn=ds.fetch_callable)):
        for f in tsearch.SearchResult._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert ds.counters.records_fetched > 0


def test_calibrate_io_fits_model_from_measured_reads(corpus, pair,
                                                     slab_dir):
    vectors, _ = corpus
    _, tidx = pair
    dsk = _disk_twin(tidx, slab_dir)
    assert dsk.engine.calibrate_io() is None           # no samples yet
    assert tidx.engine.calibrate_io() is None          # no disk store
    dsk.search_batch(_requests(tapi, vectors, n=4), with_metadata=False)
    model = dsk.engine.calibrate_io()
    assert model is not None and model.t_page_us > 0.0
    assert 1 <= model.parallelism <= 256
    assert dsk.engine.io_model is model


def test_ground_truth_matches_device_backend(corpus, pair, slab_dir):
    vectors, _ = corpus
    jidx, tidx = pair
    dsk = _disk_twin(tidx, slab_dir)
    for api_flt in (lambda api: api.Tag("cat") == 2, lambda api: None,
                    lambda api: api.Num("value") < 30.0):
        req = tapi.SearchRequest(query=vectors[3] + 0.01,
                                 filter=api_flt(tapi), k=5)
        want = tidx.ground_truth(req)
        np.testing.assert_array_equal(want, dsk.ground_truth(req))
        jreq = japi.SearchRequest(query=vectors[3] + 0.01,
                                  filter=api_flt(japi), k=5)
        np.testing.assert_array_equal(want, jidx.ground_truth(jreq))
    # a compiled Selector is verified on the device from the scanned slabs
    sel = tidx.compile_filter(tapi.Tag("cat") == 5)
    req = tapi.SearchRequest(query=vectors[7], filter=sel, k=5)
    np.testing.assert_array_equal(tidx.ground_truth(req),
                                  dsk.ground_truth(req))
    # the scan CRC-checks every record it reads
    scan = dsk.engine.disk_store.scan_records()
    np.testing.assert_array_equal(scan["vectors"],
                                  tidx.engine.store.vectors.numpy())


def test_device_budget_honesty(pair, slab_dir):
    """The disk backend's device-resident record bytes (the stub) are tiny;
    the corpus truly lives on disk (file > any sane budget)."""
    _, tidx = pair
    dsk = _disk_twin(tidx, slab_dir)
    ds = dsk.engine.disk_store
    budget = 64 * 1024
    assert ds.stub_bytes() < budget < ds.file_bytes
    s = tidx.engine.store
    dev_bytes = sum(t.numel() * t.element_size() for t in
                    (s.vectors, s.neighbors, s.dense_neighbors,
                     s.rec_labels, s.rec_values))
    assert dev_bytes > budget
    # the stub keeps the full widths and the modeled page counts
    st = dsk.engine.store
    assert (st.dim, st.degree, st.dense_degree, st.n_fields) == \
        (s.dim, s.degree, s.dense_degree, s.n_fields)
    assert (st.pages_std, st.pages_dense) == (s.pages_std, s.pages_dense)
    assert st.n == 1


def test_insert_rejected_on_disk_backend(pair, slab_dir):
    _, tidx = pair
    dsk = _disk_twin(tidx, slab_dir)
    with pytest.raises(NotImplementedError, match="disk backend"):
        dsk.engine.insert(np.zeros((1, DIM), np.float32),
                          np.array([0, 1]), np.array([0]), 8,
                          np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="device backend"):
        dsk.engine.shard(2)
    with pytest.raises(ValueError, match="slab files"):
        dsk.engine.arrays()


# ---------------------------------------------------------------------------
# Facade: build(store="disk") + checkpoints across packages
# ---------------------------------------------------------------------------

def test_index_build_save_load_roundtrip_disk(corpus, tmp_path):
    vectors, metadata = corpus
    tcfg = _port_config(tapi.IndexConfig, CFG)
    tdef = _port_config(tapi.SearchConfig, DEFAULTS)
    dsk = tapi.Index.build(vectors, metadata, tcfg, defaults=tdef,
                           store="disk", storage_dir=str(tmp_path / "slabs"),
                           device="cpu")
    assert dsk.engine.disk_store is not None
    reqs = _requests(tapi, vectors, n=3, policies=("strict_in", "post"))
    want = dsk.search_batch(reqs, with_metadata=False)

    ck = str(tmp_path / "ckpt")
    dsk.save(ck)
    meta = json.load(open(os.path.join(ck, "index_meta.json")))
    assert meta["backend"] == "disk" and "store_vectors" not in meta["arrays"]
    loaded = tapi.Index.load(ck, device="cpu")
    assert loaded.engine.disk_store is not None
    _assert_identical(want, loaded.search_batch(reqs, with_metadata=False),
                      "saved vs loaded")
    r = loaded.search(tapi.SearchRequest(query=vectors[0],
                                         filter=(tapi.Tag("cat") == 2)))
    for _, _, m in r.matches:
        cats = m["cat"] if isinstance(m["cat"], list) else [m["cat"]]
        assert 2 in cats
    # the JAX package loads the port-built disk index and answers the same
    jloaded = japi.Index.load(ck)
    assert jloaded.engine.disk_store is not None
    _assert_like_repro(jloaded.search_batch(
        _requests(japi, vectors, n=3, policies=("strict_in", "post")),
        with_metadata=False), want, "port-built disk index, repro loaded")

    # a flipped byte in the checkpointed slab file is a detected
    # corruption: load refuses to serve it (single step -> raise)
    slab = glob.glob(os.path.join(ck, "step_*", "slabs",
                                  "records.slab"))[0]
    with open(slab, "r+b") as f:
        f.seek(4096)
        f.write(b"\xff" * 4)
    with pytest.raises(CheckpointCorruptionError):
        tapi.Index.load(ck, device="cpu")
    assert glob.glob(os.path.join(ck, "*.quarantined"))


def test_index_build_rejects_unknown_store_and_sharded_disk(corpus):
    vectors, metadata = corpus
    tcfg = _port_config(tapi.IndexConfig, CFG)
    with pytest.raises(ValueError, match="store"):
        tapi.Index.build(vectors[:50], metadata[:50], tcfg, store="tape",
                         device="cpu")
    with pytest.raises(ValueError, match="device backend"):
        tapi.Index.build(vectors[:50], metadata[:50], tcfg, store="disk",
                         shards=2, device="cpu")


def test_disk_checkpoints_cross_packages(corpus, pair, slab_dir, jslab_dir,
                                         tmp_path):
    """A disk-backend checkpoint saved by either package loads in the other
    and answers as the saved index does; the slab payloads are equal."""
    vectors, _ = corpus
    jidx, tidx = pair
    pols = ("strict_in", "post", "speculative")
    tdsk = _disk_twin(tidx, slab_dir)
    jdsk = _disk_twin(jidx, jslab_dir, jax_side=True)

    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tdsk.save(tpath)
    jdsk.save(jpath)
    tmeta = json.load(open(os.path.join(tpath, "index_meta.json")))
    jmeta = json.load(open(os.path.join(jpath, "index_meta.json")))
    assert tmeta["backend"] == jmeta["backend"] == "disk"
    assert tmeta["slab_sha256"] == jmeta["slab_sha256"]
    assert tmeta["arrays"] == jmeta["arrays"]

    from_j = tapi.Index.load(jpath, device="cpu")        # repro -> port
    from_t = japi.Index.load(tpath)                      # port -> repro
    assert from_j.engine.disk_store is not None
    assert from_t.engine.disk_store is not None
    treqs = _requests(tapi, vectors, n=3, policies=pols)
    jreqs = _requests(japi, vectors, n=3, policies=pols)
    want = tidx.search_batch(treqs, with_metadata=False)
    _assert_identical(want, from_j.search_batch(treqs, with_metadata=False),
                      "repro saved, port loaded")
    _assert_like_repro(from_t.search_batch(jreqs, with_metadata=False),
                       want, "port saved, repro loaded")

"""The index lifecycle of the PyTorch port against the JAX package: build →
insert → save → load → search, on tests/test_build.py's corpus (N0=2,500,
D=24, 300 inserts, tag values 6 and 7 of "cat" only in the inserts).

One ``repro`` Index is built per module and handed to the port through
``torch_port_helpers.port_index``; the same batch is inserted into both.
After the insert the assigned ids, the vocabulary, every record's metadata
and the capacity-padded arrays are equal, and ``search_batch`` answers
equal per request (ids and integer counters exactly, distances within
1e-6). Checkpoints cross both ways: an index saved by one package loads in
the other and answers as the saved one did; a format-1 checkpoint loads in
the port; a corrupted newest step falls back to the previous one.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as eng
from repro_torch import api as tapi
from repro_torch.core import engine as teng
from torch_port_helpers import port_index

N0 = 2500
D = 24
INT_STATS = ("io_pages", "hops", "explored", "fp_explored", "n_valid",
             "dist_comps", "faults", "retries", "degraded")


@pytest.fixture(scope="module")
def corpus():
    """tests/test_build.py's corpus."""
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (8, D)).astype(np.float32)
    assign = rng.integers(0, 8, N0)
    vecs = (centers[assign]
            + rng.normal(0, 0.3, (N0, D))).astype(np.float32)
    meta = [{"cat": int(rng.integers(0, 6)),
             "v": float(rng.lognormal(2.0, 0.6))} for _ in range(N0)]
    new_vecs = (centers[rng.integers(0, 8, 300)]
                + rng.normal(0, 0.3, (300, D))).astype(np.float32)
    new_meta = [{"cat": int(rng.integers(0, 8)),
                 "v": float(rng.lognormal(2.0, 0.6))} for _ in range(300)]
    return vecs, meta, new_vecs, new_meta


@pytest.fixture(scope="module")
def pair(corpus):
    """(repro Index, port Index) over the same graph, after the same
    insert, and the ids each insert returned."""
    vecs, meta, new_vecs, new_meta = corpus
    cfg = eng.IndexConfig(r=16, r_dense=160, l_build=32, pq_m=8,
                          max_labels=8, ql=4, cap=1024)
    jidx = japi.Index.build(vecs, meta, cfg,
                            defaults=eng.SearchConfig(k=10, l=32,
                                                      max_hops=300,
                                                      max_pool=512))
    tidx = port_index(jidx)
    jids = jidx.insert(new_vecs, new_meta)
    tids = tidx.insert(new_vecs, new_meta)
    return jidx, tidx, jids, tids


def _requests(api, corpus, policy=None):
    """Tag, range, hybrid and unfiltered requests at inserted and original
    vectors, the inserted-only tag values 6 and 7 included."""
    vecs, _, new_vecs, new_meta = corpus
    tag, num = api.Tag("cat"), api.Num("v")
    out = []
    for j in range(12):
        q = new_vecs[j] if j % 2 else vecs[j]
        v = new_meta[j]["v"]
        f = (tag == new_meta[j]["cat"], num.between(v - 2.0, v + 2.0),
             tag.isin([6, 7]) | (num < 5.0), None)[j % 4]
        out.append(api.SearchRequest(query=q, filter=f, k=5, policy=policy))
    return out


def _assert_same_answers(jres, tres, tag):
    (rj, sj), (rt, st) = jres, tres
    assert st.mechanism == sj.mechanism, tag
    for f in INT_STATS:
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f),
                                      err_msg=f"{tag}: {f}")
    for i, (a, b) in enumerate(zip(rj, rt)):
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=f"{tag} #{i}")
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{tag} #{i}")
        assert b.metadata == a.metadata, f"{tag} #{i}"


def _answers(idx, api, corpus, policy):
    return idx.search_batch(_requests(api, corpus, policy), with_stats=True)


def test_insert_ids_vocab_metadata_equal(pair):
    jidx, tidx, jids, tids = pair
    np.testing.assert_array_equal(tids, jids)
    assert tids.tolist() == list(range(N0, N0 + 300))
    assert len(tidx) == len(jidx) == N0 + 300
    assert tidx.vocab == jidx.vocab
    assert ("cat", 7) in tidx.vocab
    for i in list(range(0, N0 + 300, 97)) + list(range(N0, N0 + 300, 13)):
        assert tidx.record_metadata(i) == jidx.record_metadata(i), i


ARRAYS = {
    "neighbors": lambda e: e.store.neighbors,
    "dense_neighbors": lambda e: e.store.dense_neighbors,
    "vectors": lambda e: e.store.vectors,
    "rec_labels": lambda e: e.store.rec_labels,
    "rec_values": lambda e: e.store.rec_values,
    "cand_first": lambda e: e.store.cand_first,
    "codes": lambda e: e.codes,
    "blooms": lambda e: e.mem.blooms,
    "bucket_codes": lambda e: e.mem.bucket_codes,
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_insert_arrays_equal(pair, name):
    """The capacity-padded stores after the insert, pad rows included."""
    jidx, tidx, _, _ = pair
    want = np.asarray(ARRAYS[name](jidx.engine))
    got = ARRAYS[name](tidx.engine).numpy()
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tidx.engine._builder.capacity == jidx.engine._builder.capacity
    assert got.shape[0] == tidx.engine._builder.capacity > len(tidx)


def test_host_stores_equal_after_insert(pair):
    jidx, tidx, _, _ = pair
    jl, tl = jidx.engine.label_store, tidx.engine.label_store
    for f in ("vec_offsets", "vec_labels", "inv_offsets", "inv_postings",
              "label_counts", "blooms"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    jr, tr = jidx.engine.range_store, tidx.engine.range_store
    np.testing.assert_array_equal(tr.values, jr.values)
    np.testing.assert_array_equal(tr.bucket_codes, jr.bucket_codes)


@pytest.mark.parametrize("policy", ["speculative", "post", "strict_in"])
def test_search_batch_equal_after_insert(pair, corpus, policy):
    jidx, tidx, _, _ = pair
    _assert_same_answers(_answers(jidx, japi, corpus, policy),
                         _answers(tidx, tapi, corpus, policy),
                         f"after insert/{policy}")


def test_inserted_records_found(pair, corpus):
    """An inserted vector searched under its own tag comes back first."""
    _, tidx, _, _ = pair
    _, _, new_vecs, new_meta = corpus
    found = 0
    for j in range(40):
        res = tidx.search(tapi.SearchRequest(
            query=new_vecs[j], filter=tapi.Tag("cat") == new_meta[j]["cat"],
            k=5))
        found += int(res.ids[0] == N0 + j)
        for _, _, meta in res.matches:
            assert meta["cat"] == new_meta[j]["cat"]
    assert found >= 36, found


def test_repro_saves_port_loads(pair, corpus, tmp_path):
    jidx, _, _, _ = pair
    path = str(tmp_path / "idx")
    jidx.save(path)
    loaded = tapi.Index.load(path, device="cpu")
    assert len(loaded) == len(jidx)
    assert loaded.vocab == jidx.vocab and loaded.schema.nums == ("v",)
    assert loaded.defaults.max_pool == 512
    for policy in ("speculative", "post"):
        _assert_same_answers(_answers(jidx, japi, corpus, policy),
                             _answers(loaded, tapi, corpus, policy),
                             f"repro saved, port loaded/{policy}")


def test_port_saves_repro_loads(pair, corpus, tmp_path):
    jidx, tidx, _, _ = pair
    path = str(tmp_path / "idx")
    tidx.save(path)
    loaded = japi.Index.load(path)
    assert len(loaded) == len(tidx)
    assert loaded.vocab == tidx.vocab
    for policy in ("speculative", "post"):
        _assert_same_answers(_answers(loaded, japi, corpus, policy),
                             _answers(tidx, tapi, corpus, policy),
                             f"port saved, repro loaded/{policy}")
    # and the port reads its own step back to the same answers
    again = tapi.Index.load(path, device="cpu")
    _assert_same_answers(_answers(jidx, japi, corpus, "speculative"),
                         _answers(again, tapi, corpus, "speculative"),
                         "port saved, port loaded")


def test_checkpoints_byte_identical(pair, tmp_path):
    """The same index state saves to the same leaves in both packages, and
    the sidecars agree field for field (``builder`` included)."""
    jidx, tidx, _, _ = pair
    jidx.save(str(tmp_path / "j"))
    tidx.save(str(tmp_path / "t"))
    jdir, tdir = tmp_path / "j" / "step_0", tmp_path / "t" / "step_0"
    jm = json.loads((jdir / "manifest.json").read_text())
    assert jm == json.loads((tdir / "manifest.json").read_text())
    for leaf in jm["leaves"]:
        assert (jdir / leaf["file"]).read_bytes() == \
            (tdir / leaf["file"]).read_bytes(), leaf["path"]
    jmeta = json.loads((jdir / "index_meta.json").read_text())
    tmeta = json.loads((tdir / "index_meta.json").read_text())
    assert jmeta["config"]["builder"] == "batched"
    assert jmeta == tmeta


def test_reference_builder_checkpoint_crosses_packages(corpus, tmp_path):
    """A ``builder="reference"`` index saved by either package loads in the
    other with its ``builder`` kept, the same graph, and the same sidecar
    as the other package writes for the same state."""
    vecs, meta, _, _ = corpus
    kw = dict(r=12, r_dense=48, l_build=24, pq_m=8, max_labels=8, ql=4,
              cap=1024, builder="reference")
    jidx = japi.Index.build(vecs[:800], meta[:800], eng.IndexConfig(**kw))
    tidx = port_index(jidx)
    assert tidx.engine.config.builder == "reference"
    jidx.save(str(tmp_path / "j"))
    tidx.save(str(tmp_path / "t"))
    jmeta = json.loads((tmp_path / "j" / "step_0" / "index_meta.json")
                       .read_text())
    tmeta = json.loads((tmp_path / "t" / "step_0" / "index_meta.json")
                       .read_text())
    assert jmeta["config"]["builder"] == "reference" and jmeta == tmeta
    in_port = tapi.Index.load(str(tmp_path / "j"), device="cpu")
    in_repro = japi.Index.load(str(tmp_path / "t"))
    assert in_port.engine.config.builder == "reference"
    assert in_repro.engine.config.builder == "reference"
    np.testing.assert_array_equal(in_port.engine.store.neighbors.numpy(),
                                  np.asarray(jidx.engine.store.neighbors))
    np.testing.assert_array_equal(np.asarray(in_repro.engine.store.neighbors),
                                  np.asarray(jidx.engine.store.neighbors))


def test_insert_after_load_matches_repro(pair, corpus, tmp_path):
    """Both packages load the same checkpoint and insert the same batch:
    ids and answers stay equal (the builder is created from loaded state,
    bucket bounds are the checkpoint's)."""
    jidx, _, _, _ = pair
    path = str(tmp_path / "idx")
    jidx.save(path)
    jl = japi.Index.load(path)
    tl = tapi.Index.load(path, device="cpu")
    rng = np.random.default_rng(3)
    vecs = rng.normal(0, 1, (40, D)).astype(np.float32)
    meta = [{"cat": int(rng.integers(0, 9)),
             "v": float(rng.lognormal(2.0, 0.6))} for _ in range(40)]
    np.testing.assert_array_equal(tl.insert(vecs, meta),
                                  jl.insert(vecs, meta))
    assert tl.vocab == jl.vocab and ("cat", 8) in tl.vocab
    np.testing.assert_array_equal(tl.engine.store.neighbors.numpy(),
                                  np.asarray(jl.engine.store.neighbors))
    _assert_same_answers(_answers(jl, japi, corpus, "speculative"),
                         _answers(tl, tapi, corpus, "speculative"),
                         "insert after load")


def test_legacy_checkpoint_loads_in_port(pair, corpus, tmp_path):
    """A format-1 (one numeric field, flat range arrays) checkpoint, made
    as tests/test_schema.py makes one, loads in the port and answers as the
    index it came from."""
    from test_schema import _rewrite_as_legacy_checkpoint
    jidx, _, _, _ = pair
    new_path, legacy_path = str(tmp_path / "new"), str(tmp_path / "legacy")
    jidx.save(new_path)
    _rewrite_as_legacy_checkpoint(new_path, legacy_path)
    loaded = tapi.Index.load(legacy_path, device="cpu")
    assert loaded.schema == tapi.Schema(tags=("cat",), nums=("v",))
    assert loaded.store.rec_values.shape == (len(jidx), 1)
    _assert_same_answers(_answers(jidx, japi, corpus, "speculative"),
                         _answers(loaded, tapi, corpus, "speculative"),
                         "legacy")
    assert loaded.record_metadata(N0 + 3) == jidx.record_metadata(N0 + 3)


def test_corrupted_newest_step_falls_back(pair, corpus, tmp_path):
    """tests/test_ckpt.py::test_index_load_corrupted_leaf_falls_back in the
    port: the corrupted newest step is quarantined, a stale tmp dir is
    reaped, the previous step loads; with every step corrupted the error
    propagates."""
    from repro_torch.ckpt import checkpoint as tckpt
    _, tidx, _, _ = pair
    path = str(tmp_path / "idx")
    tidx.save(path)                                       # step 0
    tidx.save(path)                                       # step 1
    os.makedirs(os.path.join(path, "step_9.tmp"))         # crashed writer
    for step in (1, 0):
        leaf = os.path.join(path, f"step_{step}", "leaf_00000.npy")
        with open(leaf, "r+b") as f:
            f.seek(80)
            f.write(b"\xde\xad\xbe\xef")
        if step == 1:
            loaded = tapi.Index.load(path, device="cpu")
            assert os.path.isdir(os.path.join(path, "step_1.quarantined"))
            assert not os.path.exists(os.path.join(path, "step_9.tmp"))
            reqs = _requests(tapi, corpus)
            for a, b in zip(tidx.search_batch(reqs),
                            loaded.search_batch(reqs)):
                np.testing.assert_array_equal(a.ids, b.ids)
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tapi.Index.load(path, device="cpu")


def test_save_with_injected_fault_keeps_previous_step(pair, tmp_path):
    """A save whose leaf write fails leaves the previous step loadable."""
    from repro_torch.core.faults import FaultInjector, FaultPlan
    _, tidx, _, _ = pair
    path = str(tmp_path / "idx")
    tidx.save(path)
    with pytest.raises(IOError, match="injected write fault"):
        tidx.save(path, injector=FaultInjector(FaultPlan(
            seed=1, ckpt_fail_rate=1.0)))
    loaded = tapi.Index.load(path, device="cpu")
    assert len(loaded) == len(tidx)
    assert not os.path.exists(os.path.join(path, "step_1.tmp"))


def test_engine_insert_validation(pair):
    _, tidx, _, _ = pair
    e = tidx.engine
    with pytest.raises(ValueError, match="vector dim"):
        e.insert(np.zeros((2, 5), np.float32), np.zeros(3, np.int64),
                 np.zeros(0, np.int32), 1, np.zeros((2, 1), np.float32))
    with pytest.raises(ValueError, match="values"):
        e.insert(np.zeros((2, D), np.float32), np.zeros(3, np.int64),
                 np.zeros(0, np.int32), 1, np.zeros((3, 1), np.float32))
    assert e.insert(np.zeros((0, D), np.float32), np.zeros(1, np.int64),
                    np.zeros(0, np.int32), 1,
                    np.zeros((0, 1), np.float32)).size == 0
    with pytest.raises(ValueError, match="not in the index schema"):
        tidx.insert(np.zeros((1, D), np.float32), [{"new": "x", "v": 1.0}])
    assert isinstance(e, teng.FilteredANNEngine)
    assert len(tidx) == N0 + 300

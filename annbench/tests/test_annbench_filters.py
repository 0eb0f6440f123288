"""Numeric fields, range and hybrid filters and the tag ceiling, on the CPU:
the generator draws what its parameters say, the reference honours the
ranges, and the program's own filter evaluation agrees with the
reference's."""
import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from annbench import harness, judge, loadgen
from annbench.corpus import make_corpus, make_numeric
from annbench.reference import Reference, matches

ROOT = Path(__file__).resolve().parents[2]
FIELDS = [{"name": "v", "law": "lognormal", "mu": 0.0, "sigma": 1.0},
          {"name": "u", "law": "uniform", "lo": -5.0, "hi": 5.0}]
SPEC = {"n": 1500, "dim": 192, "vocab": 40, "zipf_a": 1.3, "tags_mean": 4.0,
        "tags_max": 16, "latent_dim": 24, "n_clusters": 64,
        "centre_scale": 1.0, "cluster_spread": 1.0, "noise": 0.1,
        "numeric": FIELDS}
MIX = {"kind": "closed", "clients": 8, "pool": 128,
       "filters": [
           {"share": 0.25, "tags": 1, "range": None},
           {"share": 0.25, "tags": 0, "range": "v",
            "range_share": [0.02, 0.4]},
           {"share": 0.25, "tags": 1, "range": "u",
            "range_share": [0.1, 0.6]},
           {"share": 0.25, "tags": 2, "range": "v",
            "range_share": [0.2, 0.9]}],
       "request": {"k": 10, "l": 32, "policy": "speculative"}}
SEED = 2 ** 31 + 21


def test_numeric_fields_are_seeded_and_independent():
    a = make_corpus(SPEC, SEED, 16)
    b = make_corpus(SPEC, SEED, 16)
    plain = make_corpus({k: v for k, v in SPEC.items() if k != "numeric"},
                        SEED, 16)
    np.testing.assert_array_equal(a.numerics, b.numerics)
    assert a.numerics.dtype == np.float32 and a.numerics.shape == (1500, 2)
    assert a.num_names == ("v", "u")
    # the vectors and tags are those of the same corpus without the fields
    np.testing.assert_array_equal(a.vectors, plain.vectors)
    np.testing.assert_array_equal(a.tag_flat, plain.tag_flat)
    assert plain.numerics.shape == (1500, 0) and plain.num_names == ()
    # each field has its own stream: one field alone draws the same column
    alone = make_numeric(FIELDS[1], SEED, 1500)
    np.testing.assert_array_equal(alone, a.numerics[:, 1])
    assert (a.numerics[:, 0] > 0).all()
    assert (a.numerics[:, 1] >= -5).all() and (a.numerics[:, 1] < 5).all()
    assert not np.array_equal(make_corpus(SPEC, SEED + 1, 0).numerics,
                              a.numerics)


@pytest.mark.parametrize("ceiling", [0.02, 0.05])
def test_every_drawn_tag_is_under_the_ceiling(ceiling):
    spec = dict(SPEC, n=3000, vocab=400)
    corpus = make_corpus(spec, SEED, 256)
    share = np.bincount(corpus.tag_flat, minlength=corpus.vocab) / corpus.n
    traffic = {"kind": "closed", "clients": 16, "pool": 256,
               "filters": [{"share": 0.5, "tags": 1, "range": None},
                           {"share": 0.5, "tags": 2, "range": "v",
                            "range_share": [0.1, 0.5]}],
               "tag_share_max": ceiling,
               "request": {"k": 10}}
    pool = loadgen.make_pool(traffic, corpus, SEED)
    drawn = pool.tags[pool.tags >= 0]
    assert drawn.size == 256 // 2 * 3
    assert share[drawn].max() <= ceiling
    # the ceiling leaves out the popular tags, which the pool would
    # otherwise draw
    free = loadgen.make_pool(dict(traffic, tag_share_max=None), corpus, SEED)
    assert share[free.tags[free.tags >= 0]].max() > ceiling


def test_a_range_holds_its_target_share_within_one_record():
    rng = np.random.default_rng(5)
    col = np.sort(np.exp(rng.standard_normal(20000).astype(np.float32)))
    col[1000:1010] = col[1000]              # a run of ties
    n = col.size
    bounds, held, target = loadgen.draw_ranges(
        col, np.random.default_rng(9), 4000, 1e-4, 0.3)
    lo, hi = bounds[:, 0], bounds[:, 1]
    assert bounds.dtype == np.float32 and (lo < hi).all()
    assert np.isin(lo, col).all()
    assert np.isin(hi[np.isfinite(hi)], col).all()
    counted = ((col[None, :] >= lo[:, None])
               & (col[None, :] < hi[:, None])).sum(1)
    np.testing.assert_array_equal(counted, np.rint(held * n))
    ties = (np.searchsorted(col, lo, "right") - np.searchsorted(col, lo)
            - 1) + np.where(np.isfinite(hi), np.searchsorted(
                col, hi, "right") - np.searchsorted(col, hi) - 1, 0)
    assert (np.abs(held - target) * n <= 1 + ties).all()
    assert (ties > 0).any() and (ties == 0).mean() > 0.9
    # log-uniform targets span the range asked for
    assert target.min() >= 1e-4 and target.max() <= 0.3
    assert np.median(np.log10(target)) == pytest.approx(
        (np.log10(1e-4) + np.log10(0.3)) / 2, abs=0.2)


def test_a_mix_gives_one_spelling_of_its_filters():
    corpus = make_corpus(SPEC, SEED, 128)
    both = dict(MIX, filter_tags={"1": 1.0})
    with pytest.raises(ValueError, match="either"):
        loadgen.make_pool(both, corpus, SEED)
    neither = {k: v for k, v in MIX.items() if k != "filters"}
    with pytest.raises(ValueError, match="either"):
        loadgen.make_pool(neither, corpus, SEED)
    other = copy.deepcopy(MIX)
    other["filters"][1]["range"] = "w"
    with pytest.raises(ValueError, match="no numeric field"):
        loadgen.make_pool(other, corpus, SEED)


def test_pool_rounds_hold_every_kind_in_its_share():
    corpus = make_corpus(SPEC, SEED, 128)
    pool = loadgen.make_pool(MIX, corpus, SEED)
    assert pool.fields == ("v", "u")
    assert pool.ranges.shape == (128, 2, 2) and pool.ranges.dtype == np.float32
    n_tags = (pool.tags >= 0).sum(1)
    on_v = np.isfinite(pool.ranges[:, 0, 0])
    on_u = np.isfinite(pool.ranges[:, 1, 0])
    kind = np.select([~on_v & ~on_u, on_v & (n_tags == 0), on_u,
                      on_v & (n_tags == 2)], [0, 1, 2, 3], -1)
    assert (kind >= 0).all()
    assert not (on_u & on_v).any()
    streams = loadgen.ClientStreams(8, 128)
    for _ in range(16):
        rows = [streams.next(c) for c in range(8)]
        assert sorted(kind[rows]) == [0, 0, 1, 1, 2, 2, 3, 3]
    # a field with no predicate is open
    assert (pool.ranges[~on_v, 0] == [-np.inf, np.inf]).all()
    col = np.sort(corpus.numerics[:, 0])
    assert np.isin(pool.ranges[on_v, 0, 0], col).all()


def test_reference_with_ranges_against_a_plain_loop():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    tags = [sorted(set(rng.integers(0, 4, rng.integers(1, 3)).tolist()))
            for _ in range(400)]
    offsets = np.zeros(401, np.int64)
    offsets[1:] = np.cumsum([len(t) for t in tags])
    flat = np.array([t for ts in tags for t in ts], np.int32)
    nums = rng.random((400, 2), dtype=np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    qt = np.array([[0, -1], [1, -1], [-1, -1], [2, 3], [-1, -1]], np.int32)
    inf = np.inf
    qr = np.array([[[nums[7, 0], nums[9, 0]], [-inf, inf]],
                   [[-inf, inf], [0.2, 0.7]],
                   [[0.1, 0.5], [0.5, inf]],
                   [[-inf, inf], [-inf, inf]],
                   [[nums[3, 0], nums[3, 0]], [-inf, inf]]], np.float32)
    ref = Reference(x, offsets, flat, nums, 16, "cpu")
    ids, d = ref.search(q, qt, qr, 6)
    for i in range(5):
        ok = np.array([all(t in tags[n] for t in qt[i] if t >= 0)
                       and all(qr[i, f, 0] <= nums[n, f] < qr[i, f, 1]
                               for f in range(2)) for n in range(400)])
        dist = ((x.astype(np.float64) - q[i]) ** 2).sum(1)
        want = np.flatnonzero(ok)[np.argsort(dist[ok], kind="stable")][:6]
        got = ids[i][ids[i] >= 0]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(d[i][:got.size], dist[want], rtol=1e-12)
        assert ref.filter_ok(qt[i:i + 1], qr[i:i + 1], got[None]).all()
        m = matches(ref.rec_tags, torch.from_numpy(qt[i:i + 1]), ref.nums,
                    torch.from_numpy(qr[i:i + 1]))[0].numpy()
        np.testing.assert_array_equal(m, ok)
    assert ids[4].max() == -1                   # an empty range
    # a returned id outside its range is a violation; open ranges pass it
    out = np.array([[int(np.argmax(nums[:, 1] >= 0.7))]])
    assert not ref.filter_ok(qt[1:2], qr[1:2], out).all()
    assert ref.filter_ok(np.full((1, 1), -1, np.int32),
                         loadgen.open_ranges(1, 2), out).all()


def _tiny_files() -> dict:
    files = harness.cell_files(harness.load_bench(ROOT),
                               "hbm-tags.and12-c64", ROOT)
    files = copy.deepcopy(files)
    files["config"]["corpus"] = copy.deepcopy(SPEC)
    files["config"]["index"].update(r=16, r_dense=64, l_build=24, pq_m=8)
    files["config"]["server"]["max_batch"] = 8
    files["traffic"] = copy.deepcopy(MIX)
    return files


@pytest.fixture(scope="module")
def tiny_index():
    files = _tiny_files()
    corpus = make_corpus(files["config"]["corpus"], SEED,
                         files["traffic"]["pool"])
    pool = loadgen.make_pool(files["traffic"], corpus, SEED)
    index = harness.build_index(files["config"], corpus, "cpu")
    return files, corpus, pool, index


def test_program_mask_equals_the_reference_on_every_row(tiny_index):
    from repro_torch.api.filters import eval_mask
    files, corpus, pool, index = tiny_index
    assert index.schema.nums == ("v", "u")
    requests = harness.make_requests(pool, files["traffic"])
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, files["config"]["index"]["max_labels"],
                    "cpu")
    want = matches(ref.rec_tags, torch.from_numpy(pool.tags), ref.nums,
                   torch.from_numpy(pool.ranges)).numpy()
    kinds = set()
    for i, req in enumerate(requests):
        mask, _ = eval_mask(req.filter, index)
        np.testing.assert_array_equal(mask, want[i], err_msg=f"row {i}")
        kinds.add(type(index.compile_filter(req.filter)).__name__)
    assert kinds == {"LabelOrSelector", "RangeSelector", "AndSelector"}
    assert want.sum(1).max() < corpus.n


def test_range_and_hybrid_mix_served_is_correct(monkeypatch):
    monkeypatch.setattr(harness, "DRAIN_S", 2.0)
    res = harness.run_cell("tiny.range-mix", SEED, 1.0, False, "cpu", ROOT,
                           time.perf_counter(), files=_tiny_files())
    c = res["checks"]
    assert res["correct"], c
    assert c["filter_violations"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_range_violation_is_counted():
    """The judge counts an answer outside its range as a violation, though
    it carries the filter's tags."""
    corpus = make_corpus(SPEC, SEED, 128)
    pool = loadgen.make_pool(MIX, corpus, SEED)
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, 16, "cpu")
    row = int(np.flatnonzero(np.isfinite(pool.ranges[:, 0, 0])
                             & ((pool.tags >= 0).sum(1) == 0))[0])
    exact, dists = ref.search(pool.vectors[row:row + 1],
                              pool.tags[row:row + 1],
                              pool.ranges[row:row + 1], 10)
    lo, hi = pool.ranges[row, 0]
    outside = int(np.flatnonzero((corpus.numerics[:, 0] < lo)
                                 | (corpus.numerics[:, 0] >= hi))[0])
    ids = exact[0].copy()
    ids[-1] = outside
    d = ref.distances(pool.vectors[row:row + 1], ids[None])[0]
    answers = [(row, ids, d)]
    full = np.full((len(pool), 10), -1, np.int64)
    full[row] = exact[0]
    n = judge.compare(answers, 0, pool.vectors, pool.tags, pool.ranges,
                      full, ref)
    assert n["filter_violations"] == 1
    assert judge.compare(answers, 0, pool.vectors, pool.tags,
                         loadgen.open_ranges(len(pool), 1), full,
                         ref)["filter_violations"] == 0
    assert json.dumps(n)

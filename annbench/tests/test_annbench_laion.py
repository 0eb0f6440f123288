"""The LAION-shaped range deployment (``configs/laion-range-hbm.json``,
``traffic/range2-c64.json``), on the CPU: its files load, its pool holds the
two kinds of range in their shares and each range the share it was drawn
for, the program's filter evaluation agrees with the reference's over both
fields, and a served run at a small N and the configuration's widths
(d 768, PQ M 64) is correct."""
import copy
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from annbench import harness, loadgen
from annbench.corpus import make_corpus
from annbench.reference import Reference, matches

ROOT = Path(__file__).resolve().parents[2]
CELL = "hbm-laion.range2-c64"
SEED = 2 ** 31 + 2801


def _files(n: int) -> dict:
    files = copy.deepcopy(harness.cell_files(harness.load_bench(ROOT), CELL,
                                             ROOT))
    files["config"]["corpus"]["n"] = n
    return files


def test_files_load():
    files = harness.cell_files(harness.load_bench(ROOT), CELL, ROOT)
    assert files["workload"]["config"] == "laion-range-hbm"
    assert files["workload"]["traffic"] == "range2-c64"
    cfg, traffic = files["config"], files["traffic"]
    assert cfg["store"] == "device"
    assert cfg["corpus"]["dim"] == 768 and cfg["index"]["pq_m"] == 64
    assert cfg["corpus"]["dim"] % cfg["index"]["pq_m"] == 0
    assert [f["name"] for f in cfg["corpus"]["numeric"]] == ["width",
                                                             "similarity"]
    assert cfg["reduced"] == ["n"] and cfg["reduced_from"]["n"] > \
        cfg["corpus"]["n"]
    kinds = loadgen._kinds(traffic)
    assert [(k["range"], k["tags"], k["range_share"])
            for k in kinds.values()] == [("width", 0, (0.05, 0.5)),
                                         ("similarity", 0, (0.05, 0.5))]
    assert traffic["clients"] == 64 and traffic["pool"] % 64 == 0


def test_pool_holds_each_range_in_its_share():
    """Every row has one range, over width or similarity, half of each in
    every round; no row names a tag; each range holds a share of the
    corpus in [0.05, 0.5], up to one record plus the ties at its bounds."""
    files = _files(20_000)
    traffic = files["traffic"]
    corpus = make_corpus(files["config"]["corpus"], SEED, traffic["pool"])
    assert corpus.num_names == ("width", "similarity")
    assert (corpus.numerics[:, 0] > 0).all()
    assert (corpus.numerics[:, 1] >= 0.28).all()
    assert (corpus.numerics[:, 1] < 0.42).all()
    pool = loadgen.make_pool(traffic, corpus, SEED)
    assert pool.tags.shape == (traffic["pool"], 0)
    bounded = np.isfinite(pool.ranges[:, :, 0])
    assert (bounded.sum(1) == 1).all()
    field = bounded.argmax(1)
    streams = loadgen.ClientStreams(64, len(pool))
    for _ in range(len(pool) // 64):
        rows = [streams.next(c) for c in range(64)]
        assert np.bincount(field[rows], minlength=2).tolist() == [32, 32]
    n = corpus.n
    for j in (0, 1):
        col = np.sort(corpus.numerics[:, j])
        lo, hi = pool.ranges[field == j, j].T
        held = (np.searchsorted(col, hi, "left")
                - np.searchsorted(col, lo, "left"))
        ties = (np.searchsorted(col, lo, "right")
                - np.searchsorted(col, lo, "left") - 1) + np.where(
            np.isfinite(hi), np.searchsorted(col, hi, "right")
            - np.searchsorted(col, hi, "left") - 1, 0)
        assert (held >= np.floor(0.05 * n) - 1 - ties).all(), j
        assert (held <= np.ceil(0.5 * n) + 1 + ties).all(), j
        assert held.max() > 0.3 * n and held.min() < 0.07 * n, j


def _small_files(n: int) -> dict:
    """The configuration at ``n`` records with its widths (d 768, PQ M 64,
    both fields) and a smaller graph and batch, so a test run holds it."""
    files = _files(n)
    files["config"]["index"].update(r=16, r_dense=64, l_build=24)
    files["config"]["server"]["max_batch"] = 16
    files["traffic"].update(pool=256, clients=16)
    return files


def test_program_mask_equals_the_reference_over_both_fields():
    from repro_torch.api.filters import eval_mask
    files = _small_files(1500)
    corpus = make_corpus(files["config"]["corpus"], SEED,
                         files["traffic"]["pool"])
    pool = loadgen.make_pool(files["traffic"], corpus, SEED)
    index = harness.build_index(files["config"], corpus, "cpu")
    assert index.schema.nums == ("width", "similarity")
    assert index.engine.n_fields == 2
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, files["config"]["index"]["max_labels"],
                    "cpu")
    want = matches(ref.rec_tags, torch.from_numpy(pool.tags), ref.nums,
                   torch.from_numpy(pool.ranges)).numpy()
    for i, req in enumerate(harness.make_requests(pool, files["traffic"])):
        mask, _ = eval_mask(req.filter, index)
        np.testing.assert_array_equal(mask, want[i], err_msg=f"row {i}")
    assert 0 < want.sum(1).min() and want.sum(1).max() < corpus.n


def test_served_run_at_768_dims_and_64_subspaces_is_correct(monkeypatch):
    monkeypatch.setattr(harness, "DRAIN_S", 5.0)
    res = harness.run_cell(CELL, SEED, 2.0, False, "cpu", ROOT,
                           time.perf_counter(), files=_small_files(4000))
    c = res["checks"]
    assert res["correct"], c
    assert c["filter_violations"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0

"""The comparison that decides ``correct`` fails its control and every
fault a served search can have, and passes a sound run: on the CPU, at a
size a test run holds."""
import json
import time
from pathlib import Path

import numpy as np
import pytest

from annbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _small(cell: str) -> dict:
    files = harness.cell_files(harness.load_bench(ROOT), cell, ROOT)
    files["config"]["corpus"]["n"] = 1500
    files["config"]["index"].update(r=16, r_dense=64, l_build=24, pq_m=8)
    files["config"]["server"]["max_batch"] = 8
    files["traffic"].update(pool=128, clients=8)
    return files


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    files = _small(cell)
    numbers = control.control_numbers(files, 2 ** 31 + 3, 128, "cpu")
    correct, checks = harness.judge.verdict(numbers, files["limits"])
    assert not correct
    assert checks["dist_gap"]["value"] > checks["dist_gap"]["limit"]


def _run(cell, monkeypatch, fault=None, corpus=None, max_hops=None,
         search=None, traffic=None):
    monkeypatch.setattr(harness, "DRAIN_S", 2.0)
    files = _small(cell)
    files["config"]["corpus"].update(corpus or {})
    files["config"]["search"].update(search or {})
    files["traffic"].update(traffic or {})
    if max_hops is not None:
        files["config"]["search"]["max_hops"] = max_hops
    if fault is not None:
        real = harness.build_index

        def build(*a, **kw):
            index = real(*a, **kw)
            fault(index)
            return index
        monkeypatch.setattr(harness, "build_index", build)
    return harness.run_cell(cell, 2 ** 31 + 5, 1.0, False, "cpu", ROOT,
                            time.perf_counter(), files=files)


def _alter_answer(index):
    """An answer altered where it is produced: the engine's first id of
    every batch is swapped for another record's."""
    execute = index.engine.execute

    def altered(*a, **kw):
        ids, dists, st = execute(*a, **kw)
        ids = [np.array(x) for x in ids]
        ids[0][0] = (ids[0][0] + 1) % index.engine.n
        return ids, dists, st
    index.engine.execute = altered


def _drop_half(index):
    """Half of every batch left out: the server executes the first half of
    each batch it cuts and never resolves the rest."""
    import repro_torch.serve.server as srv
    real = srv.SearchServer._execute

    def half(self, batch, cost, rung):
        return real(self, batch[:max(1, len(batch) // 2)], cost, rung)
    srv.SearchServer._execute = half


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    res = _run(cell, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_alter_answer, _drop_half],
                         ids=["answer_altered", "half_batch_left_out"])
def test_faults_are_not_correct(fault, monkeypatch):
    import repro_torch.serve.server as srv
    monkeypatch.setattr(srv.SearchServer, "_execute",
                        srv.SearchServer._execute)
    res = _run(CELLS[0], monkeypatch, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("max_hops", [None, 8], ids=["sound", "8_hops"])
def test_hop_loop_cut_short_is_not_correct(monkeypatch, max_hops):
    """A hop loop that stops early (here after 8 hops, the least the
    engine allows) returns ids that pass the filter with their exact
    distances: only their recall against the exact top-10 catches it. At
    1,500 records the engine scans nearly every filter's records instead
    of walking the graph, so this corpus is larger and its 8 tags broad
    enough that most queries take the hop loop, as at full size."""
    res = _run(CELLS[0], monkeypatch, corpus={"n": 4000, "vocab": 8},
               max_hops=max_hops)
    c = res["checks"]
    if max_hops is None:
        assert res["correct"], c
        return
    assert not res["correct"], c
    assert c["recall_shortfall"]["value"] > c["recall_shortfall"]["limit"]
    assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
    assert c["filter_violations"]["value"] == 0


@pytest.mark.parametrize("delta", [None, -54], ids=["sound", "rerank_cut"])
def test_pre_route_rerank_cut_is_not_correct(monkeypatch, delta):
    """The rare-tag cell's queries take the pre route, which no hop budget
    touches. With its re-rank pool cut to k (``l_rerank_delta`` -54 at L 32,
    ``control.py --l-rerank-delta``) the route answers with the PQ scan's
    own top-10: ids that pass the filter with their exact distances, which
    only their recall against the exact top-10 catches. The corpus is
    larger than ``_small``'s and its ceiling higher, so that postings hold
    more records than the cut pool."""
    cell = "hbm-tags.rare1-c64"
    res = _run(cell, monkeypatch, corpus={"n": 4000, "vocab": 2000},
               traffic={"tag_share_max": 0.03},
               search=None if delta is None else {"l_rerank_delta": delta})
    c = res["checks"]
    if delta is None:
        assert res["correct"], c
        return
    assert not res["correct"], c
    assert c["recall_shortfall"]["value"] > c["recall_shortfall"]["limit"]
    assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
    assert c["filter_violations"]["value"] == 0

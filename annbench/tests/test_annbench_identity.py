"""The accepted cells read what they read before the harness took numeric
fields and ``filters`` mixes: their corpus, pool and requests at full size,
and the reference's exact ids over a reduced corpus, hash to the digests
that the harness gave before that change."""
import copy
import hashlib
from pathlib import Path

import numpy as np
import pytest

from annbench import harness, loadgen
from annbench.corpus import make_corpus
from annbench.reference import Reference

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (7, 2 ** 31 + 12345)
# recorded from the harness as it was before numeric fields and `filters`
# mixes; the two configurations share their corpus block
CORPUS = {
    7: "2fe04aa1af6ea1d3e2615d4000b62478171bf3fe50d5d26d93ca34a5bf048d2e",
    2 ** 31 + 12345: "53651371f3f584446112623e71933bac92b443c68ba1b7b0178ae0297a2ccfec",
}
POOL = {
    7: "896c32199e77e23065437fac4e6ee1155b8dfe49a4cddedc72fe51dc335c9ef6",
    2 ** 31 + 12345: "83be39c26c71968cb891935a452842646a644c42cc150adb19e83138e11f90db",
}
REQUESTS = {
    7: "db78e7d6b553f1645f6fb17e7d64fb423784c0281e3df4cf7bcf4e786c49a7d6",
    2 ** 31 + 12345: "952a22bbfdb894d35718fa02e34f3c226eed8c9a759a8734106c089fb6cbfc85",
}
EXACT = {
    7: "9f800d6aa096adbb9ae8790c63d79c19529025be06c8fcac2df54c69614b34ae",
    2 ** 31 + 12345: "f3d686381c5e2713c249fba31313778839ca26bb4b77ef4d27c40b87d38086cb",
}
EXACT_N, EXACT_ROWS = 4000, 256


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def request_digest(requests) -> str:
    h = hashlib.sha256()
    for r in requests:
        h.update(np.ascontiguousarray(r.query).tobytes())
        h.update(repr(r.filter).encode())
        h.update(repr(sorted(r.overrides().items())).encode())
    return h.hexdigest()


def _files(cell):
    return harness.cell_files(harness.load_bench(ROOT), cell, ROOT)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["hbm-tags.and12-c64",
                                  "ssd-tags.and12-c64"])
def test_accepted_cells_read_the_same_inputs(cell, seed):
    files = _files(cell)
    traffic = files["traffic"]
    corpus = make_corpus(files["config"]["corpus"], seed,
                         int(traffic["pool"]))
    assert _digest(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                   corpus.held_out) == CORPUS[seed]
    pool = loadgen.make_pool(traffic, corpus, seed)
    assert _digest(pool.vectors, pool.tags) == POOL[seed]
    assert request_digest(harness.make_requests(pool, traffic)) \
        == REQUESTS[seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["hbm-tags.and12-c64",
                                  "ssd-tags.and12-c64"])
def test_accepted_cells_exact_ids_unchanged(cell, seed):
    files = _files(cell)
    spec = copy.deepcopy(files["config"]["corpus"])
    spec["n"] = EXACT_N
    traffic = files["traffic"]
    corpus = make_corpus(spec, seed, int(traffic["pool"]))
    pool = loadgen.make_pool(traffic, corpus, seed)
    # as the harness calls it: with the corpus's numerics and the pool's
    # ranges, both empty in these cells
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, files["config"]["index"]["max_labels"],
                    "cpu")
    assert corpus.numerics.shape == (EXACT_N, 0)
    ids, dists = ref.search(pool.vectors[:EXACT_ROWS],
                            pool.tags[:EXACT_ROWS],
                            pool.ranges[:EXACT_ROWS], 10)
    assert _digest(ids, dists) == EXACT[seed]

"""The benchmark's corpus: seeded, vectorised, and navigable."""
import numpy as np
import pytest

from annbench.corpus import make_corpus

SPEC = {"n": 2000, "dim": 192, "vocab": 200386, "zipf_a": 1.3,
        "tags_mean": 4.0, "tags_max": 16, "latent_dim": 24,
        "n_clusters": 1024, "centre_scale": 1.0, "cluster_spread": 1.0,
        "noise": 0.1}


def _arrays(c):
    return (c.vectors, c.tag_offsets, c.tag_flat, c.held_out)


def test_same_seed_same_arrays_other_seed_other_arrays():
    a = make_corpus(SPEC, 2 ** 31 + 11, 64)
    b = make_corpus(SPEC, 2 ** 31 + 11, 64)
    c = make_corpus(SPEC, 2 ** 31 + 12, 64)
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.vectors, c.vectors)
    assert not np.array_equal(a.tag_flat[:100], c.tag_flat[:100])
    assert not np.array_equal(a.held_out, c.held_out)


def test_tags_are_distinct_ascending_and_bounded():
    c = make_corpus(SPEC, 7, 16)
    counts = np.diff(c.tag_offsets)
    assert counts.min() >= 1 and counts.max() <= SPEC["tags_max"]
    assert c.tag_offsets[-1] == c.tag_flat.size
    for s, e in zip(c.tag_offsets[:-1], c.tag_offsets[1:]):
        row = c.tag_flat[s:e]
        assert np.all(np.diff(row) > 0)
    assert c.tag_flat.min() >= 0 and c.tag_flat.max() < SPEC["vocab"]
    assert c.vectors.dtype == np.float32 and c.vectors.shape == (2000, 192)
    assert c.held_out.shape == (16, 192)


@pytest.mark.parametrize("source", ["annbench", "synth"])
def test_build_reaches_the_graph(source):
    """The port's batched build over the benchmark's corpus reaches nearly
    every node from the medoid; over ``synth.make_filtered_dataset``'s 32
    far-apart clusters it stays in one cluster. Measured at N = 2,000, R 16,
    L 32 on the CPU: 0.99 against 0.03."""
    from repro_torch.core import graph
    from repro_torch.data.synth import make_filtered_dataset
    n = SPEC["n"]
    if source == "annbench":
        x = make_corpus(SPEC, 3, 0).vectors
    else:
        x = make_filtered_dataset(n=n, d=192, n_queries=1, n_labels=1000,
                                  seed=0).vectors
    adj, medoid = graph.build_vamana_batched(x, 16, 32, 1.2, device="cpu")
    share = graph.reachable_fraction(adj, medoid)
    if source == "annbench":
        assert share >= 0.95
    else:
        assert share <= 0.2

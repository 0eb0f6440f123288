"""The benchmark's corpus: vectors and bag-of-tags metadata made from a seed.

Vectors lie near a low-dimensional manifold, as embeddings do: a mixture
of ``n_clusters`` Gaussian clusters in a ``latent_dim``-dimensional space,
whose centres lie no farther apart than a cluster's own spread, mapped into
``dim`` dimensions by one fixed random linear map, plus a small isotropic
noise in every dimension. Clusters therefore overlap, so a Vamana graph
over them stays connected (a mixture of far-apart clusters leaves RobustPrune
no edge between clusters, and a search started at the medoid never leaves
its cluster).

Tags are drawn independently of the vectors: each record gets
Poisson(``tags_mean``) tags, clipped to [1, ``tags_max``], each drawn from
a Zipf(``zipf_a``) law over a vocabulary of ``vocab`` tags; repeats within
a record are dropped. Everything is vectorised numpy, so the same seed
gives the same arrays on any machine. The query vectors are drawn from the
same law and held out of the corpus.

A configuration may give its records numeric fields, as a list
``numeric`` in the ``corpus`` block, one entry a field:
``{"name": "v", "law": "lognormal", "mu": 0.0, "sigma": 1.0}`` (exp of a
normal) or ``{"name": "v", "law": "uniform", "lo": 0.0, "hi": 1.0}``. Each
field is drawn in float32 from a stream of its own, independent of the
vectors, the tags and the other fields. Without the key the records carry
none: ``numerics`` is (N, 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    vectors: np.ndarray        # (N, dim) float32
    tag_offsets: np.ndarray    # (N + 1,) int64, CSR over tag_flat
    tag_flat: np.ndarray       # (nnz,) int32 tag ids, ascending per record
    vocab: int
    held_out: np.ndarray       # (Q, dim) float32, drawn like vectors
    numerics: np.ndarray       # (N, F) float32, one column a numeric field
    num_names: tuple           # (F,) the fields' names, in column order

    @property
    def n(self) -> int:
        return self.vectors.shape[0]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one named use of the run's seed."""
    key = [int(b) for b in stream.encode()]
    return np.random.default_rng([int(seed) % 2 ** 64, *key])


def make_vectors(spec: dict, seed: int, count: int) -> np.ndarray:
    rng = rng_for(seed, "vectors")
    m, d = int(spec["latent_dim"]), int(spec["dim"])
    c = int(spec["n_clusters"])
    centres = rng.standard_normal((c, m), dtype=np.float32)
    centres *= np.float32(spec["centre_scale"])
    proj = rng.standard_normal((m, d), dtype=np.float32)
    proj /= np.float32(np.sqrt(m))
    assign = rng.integers(0, c, count)
    z = rng.standard_normal((count, m), dtype=np.float32)
    z *= np.float32(spec["cluster_spread"])
    z += centres[assign]
    x = z @ proj
    x += rng.standard_normal((count, d), dtype=np.float32) * np.float32(
        spec["noise"])
    return x.astype(np.float32, copy=False)


def zipf_cdf(vocab: int, a: float) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(a)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def make_tags(spec: dict, seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR (offsets, flat) of each record's distinct tags, ascending."""
    rng = rng_for(seed, "tags")
    counts = rng.poisson(float(spec["tags_mean"]), n).clip(
        1, int(spec["tags_max"]))
    owner = np.repeat(np.arange(n, dtype=np.int64), counts)
    draws = np.searchsorted(zipf_cdf(int(spec["vocab"]), spec["zipf_a"]),
                            rng.random(owner.size)).astype(np.int64)
    # one sort by (record, tag) puts repeats side by side
    key = owner * int(spec["vocab"]) + draws
    key.sort()
    keep = np.ones(key.size, bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    rec = key // int(spec["vocab"])
    flat = (key % int(spec["vocab"])).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rec, minlength=n), out=offsets[1:])
    return offsets, flat


def make_numeric(field: dict, seed: int, n: int) -> np.ndarray:
    """(n,) float32 values of one numeric field, from its own stream."""
    rng = rng_for(seed, "numeric:" + field["name"])
    law = field["law"]
    if law == "lognormal":
        z = rng.standard_normal(n, dtype=np.float32)
        return np.exp(np.float32(field["mu"]) + np.float32(field["sigma"]) * z)
    if law == "uniform":
        lo, hi = np.float32(field["lo"]), np.float32(field["hi"])
        return lo + (hi - lo) * rng.random(n, dtype=np.float32)
    raise ValueError(f"numeric field {field['name']!r}: unknown law {law!r}")


def make_corpus(spec: dict, seed: int, held_out: int) -> Corpus:
    """The corpus of a configuration's ``corpus`` block, with ``held_out``
    more vectors drawn from the same law for queries."""
    n = int(spec["n"])
    x = make_vectors(spec, seed, n + held_out)
    offsets, flat = make_tags(spec, seed, n)
    fields = spec.get("numeric", [])
    names = tuple(f["name"] for f in fields)
    if len(set(names)) != len(names):
        raise ValueError(f"numeric fields named twice: {names}")
    nums = np.zeros((n, len(fields)), np.float32)
    for j, f in enumerate(fields):
        nums[:, j] = make_numeric(f, seed, n)
    return Corpus(vectors=x[:n], tag_offsets=offsets, tag_flat=flat,
                  vocab=int(spec["vocab"]), held_out=x[n:], numerics=nums,
                  num_names=names)

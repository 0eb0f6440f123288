"""Shared helpers of the ``tests/test_torch_*.py`` parity suites: hand the
JAX package's engine state to the PyTorch port as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

# The suite runs as several pytest workers on one host; one intra-op thread
# per worker keeps the port's small CPU tensor ops from oversubscribing the
# cores that the other workers' JAX tests use.
torch.set_num_threads(1)


def repro_arrays(e, ds=None) -> dict:
    """A ``repro`` engine's state in the layout of
    ``repro_torch.core.engine.FilteredANNEngine.from_arrays``. The raw
    label and value arrays come from the dataset ``ds``, or from the
    engine's own label and range stores when there is none."""
    if ds is None:
        ls = e.label_store
        raw = {"label_offsets": np.asarray(ls.vec_offsets),
               "label_flat": np.asarray(ls.vec_labels),
               "n_labels": int(ls.n_labels),
               "values": np.asarray(e.range_store.values)}
    else:
        raw = {"label_offsets": np.asarray(ds.label_offsets),
               "label_flat": np.asarray(ds.label_flat),
               "n_labels": int(ds.n_labels),
               "values": np.asarray(ds.values)}
    s = e.store
    return {
        "vectors": np.asarray(s.vectors),
        "neighbors": np.asarray(s.neighbors),
        "dense_neighbors": np.asarray(s.dense_neighbors),
        "rec_labels": np.asarray(s.rec_labels),
        "rec_values": np.asarray(s.rec_values),
        "codes": np.asarray(e.codes),
        "centroids": np.asarray(e.codebook.centroids),
        "medoid": int(e.medoid),
        "blooms": np.asarray(e.mem.blooms),
        "bucket_codes": np.asarray(e.mem.bucket_codes),
        **raw,
    }


def _port_config(cls, cfg):
    """A port config dataclass with the fields of ``repro``'s ``cfg``."""
    import dataclasses
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def port_engine(e, ds=None):
    """The port's engine on the CPU over the same graph, codebook and
    attributes as the ``repro`` engine ``e``."""
    from repro_torch.core import engine as teng
    return teng.FilteredANNEngine.from_arrays(
        repro_arrays(e, ds), _port_config(teng.IndexConfig, e.config),
        device="cpu")


def port_index(idx):
    """The port's ``Index`` on the CPU over the state of ``repro``'s Index
    ``idx``: its engine's arrays, vocabulary, schema and defaults."""
    from repro_torch import api as tapi
    schema = tapi.Schema(tags=idx.schema.tags, nums=idx.schema.nums)
    return tapi.Index(port_engine(idx.engine), dict(idx.vocab), schema,
                      _port_config(tapi.SearchConfig, idx.defaults))


# --- seeded kernel inputs (the generators of tests/test_kernels.py) ---

def hop_inputs(rng, b, c, m=8, k=256, f=3, ql=8, nr=4):
    """tests/test_kernels.py's generator, as numpy."""
    codes = rng.integers(0, k, (b, c, m)).astype(np.uint8)
    blooms = rng.integers(0, 2 ** 31, (b, c), dtype=np.int64).astype(np.int32)
    buckets = rng.integers(0, 256, (b, c, f)).astype(np.int32)
    in_merged = rng.integers(0, 2, (b, c)).astype(bool)
    table = rng.normal(0, 1, (b, m, k)).astype(np.float32)
    scalars = np.stack([rng.integers(0, 2 ** 16, b), rng.integers(0, 3, b),
                        rng.integers(0, 3, b), rng.integers(0, 2, b)],
                       axis=1).astype(np.int32)
    or_masks = rng.integers(0, 2 ** 12, (b, ql)).astype(np.int32)
    range_field = np.where(rng.random((b, nr)) < 0.5,
                           rng.integers(0, f, (b, nr)), -1).astype(np.int32)
    lo = rng.integers(0, 128, (b, nr)).astype(np.int32)
    hi = rng.integers(128, 256, (b, nr)).astype(np.int32)
    return (codes, blooms, buckets, in_merged, table, scalars, or_masks,
            range_field, lo, hi)


def or_inputs(b, nw, c, seed):
    rng = np.random.default_rng(seed * 997 + b * nw * c)
    words = rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                         dtype=np.int64).astype(np.int32)
    slots = rng.integers(-8, nw * 32 + 8, (b, c)).astype(np.int32)
    return words, slots


def prune_inputs(rng, b, c, pad_frac=0.3):
    dp = np.sort(rng.normal(2, 1, (b, c)).astype(np.float32) ** 2, axis=1)
    for i, k in enumerate(rng.integers(0, max(1, int(c * pad_frac)), b)):
        if k:
            dp[i, -k:] = np.inf
    dcc = rng.normal(0, 1, (b, c, c)).astype(np.float32) ** 2
    dcc = (dcc + dcc.transpose(0, 2, 1)) / 2
    for i in range(b):
        np.fill_diagonal(dcc[i], 0.0)
    return dp, dcc

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


def gather_inputs(rng, b, c, n, m=8, k=256, f=3, ql=8, nr=4,
                  merged_mode=None):
    """Inputs of ``hop_fused_gather``: stores of ``n`` rows, a rare-list
    bitmap of ceil((n+1)/32) words per query, and ids (B, C) in [0, n) that
    include 0, n-1 and repeats; the per-query parameters as
    :func:`hop_inputs` draws them, with every query's merged_mode set to
    ``merged_mode`` when given. Returns the ``hop_fused_gather`` argument
    tuple as numpy."""
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    blooms = rng.integers(0, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    buckets = rng.integers(0, 256, (n, f)).astype(np.int32)
    nw = (n + 1 + 31) // 32
    merged = rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                          dtype=np.int64).astype(np.int32)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    ids[:, 0] = 0
    ids[:, -1] = n - 1
    if c > 2:
        ids[:, 1] = ids[:, 2]                     # a repeated id
    (_, _, _, _, table, scalars, or_masks, range_field, lo,
     hi) = hop_inputs(rng, b, 1, m=m, k=k, f=f, ql=ql, nr=nr)
    if merged_mode is not None:
        scalars[:, 2] = merged_mode
    return (codes, blooms, buckets, merged, ids, table, scalars, or_masks,
            range_field, lo, hi)


def gathered_slab(args):
    """The (B, C) slab that ``hop_fused_gather``'s ``args`` name, gathered
    with numpy: the argument tuple of ``hop_fused``."""
    (codes, blooms, buckets, merged, ids, table, scalars, or_masks,
     range_field, lo, hi) = args
    words = np.take_along_axis(merged, ids >> 5, axis=1)
    in_merged = ((words >> (ids & 31)) & 1).astype(bool)
    return (codes[ids], blooms[ids], buckets[ids], in_merged, table, scalars,
            or_masks, range_field, lo, hi)


PRUNE_KINDS = ("nonfinite_middle", "unsorted", "ties", "r_ge_c", "all_inf")


def prune_edge_inputs(rng, kind, b, c):
    """A ``prune_scan`` case that the kernel's skip logic must get right:
    non-finite lanes (+inf, nan) amid finite ones; unsorted dp; exact ties
    a2·dcc == dp (a2 = 4, so the product is exact); r >= C; a row that is
    all +inf. Returns ``(dp, dcc, a2, r)`` as numpy and Python numbers."""
    dp, dcc = prune_inputs(rng, b, c, pad_frac=0.0)
    a2, r = 1.44, max(1, c // 3)
    if kind == "nonfinite_middle":
        for i in range(b):
            pos = rng.choice(c, size=max(1, c // 4), replace=False)
            dp[i, pos] = np.inf
            dp[i, pos[::3]] = np.nan
    elif kind == "unsorted":
        dp = rng.permuted(dp, axis=1)
    elif kind == "ties":
        a2 = 4.0
        tie = rng.random((b, c, c)) < 0.3
        dcc = np.where(tie, (dp[:, None, :] / np.float32(4.0)),
                       dcc).astype(np.float32)
    elif kind == "r_ge_c":
        r = c + 3
        dcc = dcc + np.float32(3.0)               # little pruning
    elif kind == "all_inf":
        dp[0] = np.inf
    else:
        raise ValueError(kind)
    return dp.astype(np.float32), dcc.astype(np.float32), a2, r

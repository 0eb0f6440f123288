"""Record store: the on-"SSD" tier, as device tensors.

Counterpart of ``repro.core.records``. Each logical record co-locates
(paper Fig. 1 + §4.1):
    full-precision vector | out-neighbor IDs | [2-hop neighbor IDs] | attributes

Attributes ride in the record's final-page slack, so exact verification
during re-ranking costs no extra I/O. ``pages_std`` / ``pages_dense`` give
the page cost of one record fetch without / with the densified 2-hop list.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.core import io_sim

FIRST_CHUNK = 1 << 16     # rows per candidate_first_mask sort


class HopGraphs:
    """What the hop loop (``search.run_hops``) keeps with one store on the
    card: the CUDA graphs it captured over the store's tensors, by shape
    (``search._HopGraph``), and what their replays share. A store is built
    with an empty one and frees it with its tensors."""

    def __init__(self):
        self.lock = threading.Lock()  # held by every use, capture included
        self.graphs: dict = {}        # shape key -> search._HopGraph
        self.pool = None              # the graphs' one memory pool
        self.done = None              # CUDA event: the end of the last use
        self.buckets = None           # (InMemory, its bucket codes in int32)


class RecordStore(NamedTuple):
    vectors: torch.Tensor          # (N, D) float32 — full precision
    neighbors: torch.Tensor        # (N, R) int32, padded -1
    dense_neighbors: torch.Tensor  # (N, R_d) int32, padded -1 (2-hop sample)
    rec_labels: torch.Tensor       # (N, ML) int32, padded -1
    rec_values: torch.Tensor       # (N, F) float32 — one column per field
    pages_std: int                 # pages per standard-record fetch
    pages_dense: int               # pages per densified-record fetch
    # (N, R+R_d) bool: first slab-order occurrence of each id within the
    # record's candidate list [neighbors ++ dense_neighbors] (-1 pads False);
    # query-independent, so derived once per build (candidate_first_mask)
    cand_first: torch.Tensor | None = None
    # the hop loop's CUDA graphs over these tensors (over a disk tier's
    # stand-in, with the fetch between them); None (a shard, a dry run)
    # runs every hop eagerly
    hop_graphs: HopGraphs | None = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def dense_degree(self) -> int:
        return self.dense_neighbors.shape[1]

    @property
    def n_fields(self) -> int:
        return self.rec_values.shape[1]


def candidate_first_mask(neighbors: torch.Tensor,
                         dense_neighbors: torch.Tensor) -> torch.Tensor:
    """(N, R+R_d) bool — True at the first occurrence of each id within one
    record's candidate list ``[neighbors ++ dense_neighbors]``; -1 pads are
    False. A row-wise stable sort keeps equal ids in slab order, so "first
    in its sorted run" is "first in slab order". Runs on the tensors' device
    in row chunks (the sort's index tensor is 8 bytes per entry)."""
    out = []
    for s in range(0, neighbors.shape[0], FIRST_CHUNK):
        cand = torch.cat([neighbors[s:s + FIRST_CHUNK],
                          dense_neighbors[s:s + FIRST_CHUNK]], dim=1)
        srt, order = torch.sort(cand, dim=1, stable=True)
        first_sorted = torch.ones_like(srt, dtype=torch.bool)
        first_sorted[:, 1:] = srt[:, 1:] != srt[:, :-1]
        first = torch.zeros_like(first_sorted).scatter_(1, order, first_sorted)
        out.append(first & (cand >= 0))
    if not out:
        return torch.zeros((0, neighbors.shape[1] + dense_neighbors.shape[1]),
                           dtype=torch.bool, device=neighbors.device)
    return torch.cat(out)


def make_record_store(vectors, neighbors, dense_neighbors, rec_labels,
                      rec_values, device, vec_dtype_size: int = 4) \
        -> RecordStore:
    """Host or device arrays in, a RecordStore of tensors on ``device`` out.
    The vectors are held in float32 whatever their source; the page counts
    are figured for vectors of ``vec_dtype_size`` bytes an element, as the
    slab would store them."""
    def dev(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(device).contiguous()

    vectors = dev(vectors, torch.float32)
    neighbors = dev(neighbors, torch.int32)
    dense_neighbors = dev(dense_neighbors, torch.int32)
    rec_labels = dev(rec_labels, torch.int32)
    rec_values = dev(rec_values, torch.float32)
    if rec_values.ndim == 1:            # legacy single-field call sites
        rec_values = rec_values[:, None].contiguous()
    n, d = vectors.shape
    ml = rec_labels.shape[1]
    n_fields = rec_values.shape[1]
    pages_std = io_sim.record_pages(d, vec_dtype_size, neighbors.shape[1],
                                    ml, n_fields)
    pages_dense = io_sim.record_pages(
        d, vec_dtype_size, neighbors.shape[1] + dense_neighbors.shape[1], ml,
        n_fields)
    return RecordStore(vectors, neighbors, dense_neighbors, rec_labels,
                       rec_values, pages_std, pages_dense,
                       candidate_first_mask(neighbors, dense_neighbors),
                       HopGraphs())

"""The plain reference: exact filtered top-k by brute force, in PyTorch.

It reads only what the benchmark generated (the corpus vectors, each
record's tags and numeric fields, the queries, their tags and their ranges)
and nothing of the program: no label store, no range store, no codes, no
graph. The filter is evaluated from those arrays (a record matches when it
carries every tag of the query and each of its fields lies in the query's
half-open range over it, compared in float32); the distances are squared
L2. Candidates are picked by a float32
matrix product with TF32 off, ``margin`` more than asked, and re-ranked by
the difference form in float64, so the order and the distances returned are
exact to float64 rounding. ``dtype`` lower than float32 (the control) runs
the whole search in that type instead and reports its own distances.
"""
from __future__ import annotations

import numpy as np
import torch


def padded_tags(offsets: np.ndarray, flat: np.ndarray,
                width: int) -> np.ndarray:
    """(N, width) int32 tags of each record, -1 padded."""
    counts = np.diff(offsets)
    if counts.size and counts.max() > width:
        raise ValueError(f"a record has {counts.max()} tags, more than "
                         f"{width}")
    out = np.full((counts.size, width), -1, np.int32)
    rows = np.repeat(np.arange(counts.size), counts)
    cols = np.arange(flat.size) - np.repeat(offsets[:-1], counts)
    out[rows, cols] = flat
    return out


def matches(rec_tags: torch.Tensor, q_tags: torch.Tensor,
            rec_nums: torch.Tensor, q_ranges: torch.Tensor) -> torch.Tensor:
    """(B, N) bool: record n carries every tag of query b and each of its
    numeric fields ``rec_nums`` (N, F) lies in query b's range ``q_ranges``
    (B, F, 2): lo <= v < hi. ``q_tags`` (B, T) is -1 padded; a query with no
    tag and open ranges matches everything."""
    ok = torch.ones((q_tags.shape[0], rec_tags.shape[0]), dtype=torch.bool,
                    device=rec_tags.device)
    for t in range(q_tags.shape[1]):
        tag = q_tags[:, t]
        has = (rec_tags[None, :, :] == tag[:, None, None]).any(-1)
        ok &= has | (tag < 0)[:, None]
    for f in range(q_ranges.shape[1]):
        v = rec_nums[None, :, f]
        ok &= (q_ranges[:, f, 0:1] <= v) & (v < q_ranges[:, f, 1:2])
    return ok


class Reference:
    """Exact filtered search over one corpus, held on ``device``;
    ``numerics`` (N, F) are the records' numeric fields (F may be 0)."""

    def __init__(self, vectors: np.ndarray, tag_offsets: np.ndarray,
                 tag_flat: np.ndarray, numerics: np.ndarray, max_tags: int,
                 device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.x = torch.from_numpy(np.ascontiguousarray(vectors)).to(
            self.device)
        self.rec_tags = torch.from_numpy(
            padded_tags(tag_offsets, tag_flat, max_tags)).to(self.device)
        self.nums = torch.from_numpy(
            np.ascontiguousarray(numerics, np.float32)).to(self.device)

    def search(self, queries: np.ndarray, q_tags: np.ndarray,
               q_ranges: np.ndarray, k: int, block: int = 32,
               margin: int = 16):
        """(ids (Q, k) int64 -1 padded, dists (Q, k) float64 +inf padded)
        of the exact filtered top-k of each query; ``q_ranges`` (Q, F, 2)
        are the queries' ranges."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._search(queries, q_tags, q_ranges, k, block, margin)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _search(self, queries, q_tags, q_ranges, k, block, margin):
        q_all = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        t_all = torch.from_numpy(np.ascontiguousarray(q_tags, np.int32))
        r_all = torch.from_numpy(np.ascontiguousarray(q_ranges, np.float32))
        x = self.x.to(self.dtype)
        x_sq = (x ** 2).sum(1)
        n = x.shape[0]
        take = min(k + margin, n)
        ids_out = np.full((q_all.shape[0], k), -1, np.int64)
        d_out = np.full((q_all.shape[0], k), np.inf, np.float64)
        for s in range(0, q_all.shape[0], block):
            q = q_all[s:s + block].to(self.device)
            ok = matches(self.rec_tags, t_all[s:s + block].to(self.device),
                         self.nums, r_all[s:s + block].to(self.device))
            qd = q.to(self.dtype)
            d = x_sq[None, :] - 2 * (qd @ x.T) + (qd ** 2).sum(1,
                                                               keepdim=True)
            d = torch.where(ok, d.float(), torch.inf)
            cand = torch.topk(d, take, dim=1, largest=False).indices
            # ids ascending first, so a stable sort by distance breaks
            # ties by id
            cand = torch.sort(cand, dim=1).values
            if self.dtype == torch.float32:
                exact = ((self.x[cand].double() - q[:, None, :].double())
                         ** 2).sum(-1)
            else:
                exact = torch.gather(d, 1, cand).double()
            exact = torch.where(torch.gather(ok, 1, cand), exact, torch.inf)
            order = torch.argsort(exact, dim=1, stable=True)[:, :k]
            ids = torch.gather(cand, 1, order)
            dist = torch.gather(exact, 1, order)
            ids = torch.where(torch.isfinite(dist), ids, -1)
            m = min(k, take)
            ids_out[s:s + block, :m] = ids.cpu().numpy()
            d_out[s:s + block, :m] = dist.cpu().numpy()
        return ids_out, d_out

    def distances(self, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """(Q, K) float64 squared L2 of each query to the records ``ids``
        (Q, K) names; NaN where an id is out of range."""
        ids = np.asarray(ids, np.int64)
        valid = (ids >= 0) & (ids < self.x.shape[0])
        safe = torch.from_numpy(np.where(valid, ids, 0)).to(self.device)
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        d = ((self.x[safe].double() - q[:, None, :].double()) ** 2).sum(-1)
        return np.where(valid, d.cpu().numpy(), np.nan)

    def filter_ok(self, q_tags: np.ndarray, q_ranges: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
        """(Q, K) bool: record ``ids[q, j]`` exists, carries every tag of
        query q and has each numeric field in query q's range over it
        (``q_ranges`` (Q, F, 2))."""
        ids = np.asarray(ids, np.int64)
        valid = (ids >= 0) & (ids < self.x.shape[0])
        safe = torch.from_numpy(np.where(valid, ids, 0)).to(self.device)
        rt = self.rec_tags[safe]                            # (Q, K, W)
        qt = torch.from_numpy(np.ascontiguousarray(q_tags, np.int32)).to(
            self.device)                                    # (Q, T)
        has = (rt[:, :, None, :] == qt[:, None, :, None]).any(-1)
        ok = (has | (qt < 0)[:, None, :]).all(-1)
        qr = torch.from_numpy(np.ascontiguousarray(q_ranges, np.float32)).to(
            self.device)
        v = self.nums[safe]                                 # (Q, K, F)
        ok &= ((qr[:, None, :, 0] <= v) & (v < qr[:, None, :, 1])).all(-1)
        return valid & ok.cpu().numpy()

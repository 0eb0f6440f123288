"""The yardstick of the kernels: the card's peaks, and the least bytes and
operations each kernel entry of the program needs for one call.

A call is counted from the logical shapes of its operands at the entry
(``repro_torch.kernels.ops``), each input read once and each output written
once, whatever implements it. The formulas are those the port's kernel table
was measured against (``bound`` in ``chip_smoke.py``), frozen here.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def _shape(t) -> tuple:
    return tuple(int(x) for x in t.shape)


def hop_fused_gather(codes, blooms, buckets, merged_words, ids, table,
                     scalars, or_masks, range_field, *_):
    """ids, the gathered rows (code row, bloom word, bucket words), one
    rare-list word per candidate, the tables and parameters, the outputs
    (a float key and a bool a candidate)."""
    b, c = _shape(ids)
    _, m = _shape(codes)
    f = _shape(buckets)[-1]
    k = _shape(table)[-1]
    ql, nr = _shape(or_masks)[-1], _shape(range_field)[-1]
    nbytes = (b * c * 4 + b * c * (m + 4 + 4 * f) + b * c * 4
              + b * m * k * 4 + b * (4 + ql + 3 * nr) * 4 + b * c * 5)
    return nbytes, b * c * m


def or_scatter_(words, ids, n_ids=None):
    """Per id: the id, and one 32-byte sector read and written back."""
    b, c = _shape(ids)
    return b * c * (4 + 32), b * c


def or_scatter_new(ids, nw, n_ids=None):
    """The ids read once and the fresh table written once."""
    b, c = _shape(ids)
    return b * int(nw) * 4 + b * c * 4, b * c


def pq_scan(codes, table):
    n, m = _shape(codes)
    k = _shape(table)[-1]
    return n * m + m * k * 4 + n * 4, n * m


def pq_scan_gather(codes, ids, table):
    """Per id: the id, its code row, the distance out; the table once."""
    _, m = _shape(codes)
    k = _shape(table)[-1]
    c = _shape(ids)[0]
    return c * (4 + m + 4) + m * k * 4, c * m


# the entries the search path calls, by their names in ``ops``
ENTRIES = {f.__name__: f for f in (hop_fused_gather, or_scatter_,
                                   or_scatter_new, pq_scan, pq_scan_gather)}

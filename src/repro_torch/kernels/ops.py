"""Kernel dispatch: CUDA tensors launch the hand-written kernel, CPU tensors
take the plain PyTorch version in ``kernels/ref.py``.

The choice follows the device of the tensors handed in, never
``torch.cuda.is_available()``, and nothing falls back: a kernel that fails to
build or launch raises. Each wrapper counts its kernel launches in
``LAUNCHES`` (one per launch, nowhere else), so a run can show that its path
went through the kernels; :func:`reset_launches` zeroes the counts and
:func:`snapshot`/:func:`restore` read and put them back. The serving tier
launches from its worker thread while callers may launch from theirs, so the
counts are read and written only under a lock.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref

LAUNCHES = {"hop_fused": 0, "or_scatter": 0, "prune_scan": 0, "pq_scan": 0,
            "approx_probe": 0, "l2_rerank": 0}


_count_lock = threading.Lock()

# Dynamic shared memory a block may take on the H100 once its kernel opts in:
# the ceiling of the lookup tables that hop_fused and pq_scan stage, which
# opt in above 48 KB. It mirrors cudaDevAttrMaxSharedMemoryPerBlockOptin
# (227 KB there), which the kernels read from the card (csrc/smem_optin.cuh);
# here it only refuses a too-wide table with a ValueError before a launch.
SMEM_OPTIN_BYTES = 232_448
HF_TABLE_OFFSET = 16      # bytes hop_fused puts before its table
# M -> the alignment of hop_fused's vector loads of a code row of M bytes
_ROW_ALIGN = {4: 4, 8: 8, 16: 16, 32: 16, 64: 16}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def snapshot() -> dict:
    """A copy of the launch counts."""
    with _count_lock:
        return dict(LAUNCHES)


def restore(counts: dict) -> None:
    """Put back counts taken with :func:`snapshot`."""
    with _count_lock:
        LAUNCHES.update(counts)


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(fn_name: str, *args) -> None:
    from repro_torch.kernels.build import library
    err = getattr(library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_hop_params(b, m, table, scalars, or_masks, range_field,
                      bucket_lo, bucket_hi, dev) -> None:
    """The per-query inputs of both ``hop_fused`` entries: the table is
    staged by one bulk copy, so it must start on 16 bytes and span a
    multiple of 16 bytes."""
    k = table.shape[-1]
    nr = range_field.shape[-1]
    _check("table", table, torch.float32, (b, m, k), dev)
    _check("scalars", scalars, torch.int32, (b, 4), dev)
    _check("or_masks", or_masks, torch.int32, (b, or_masks.shape[-1]), dev)
    for name, t in (("range_field", range_field), ("bucket_lo", bucket_lo),
                    ("bucket_hi", bucket_hi)):
        _check(name, t, torch.int32, (b, nr), dev)
    if HF_TABLE_OFFSET + m * k * 4 > SMEM_OPTIN_BYTES:
        raise ValueError(f"hop_fused: table of {m}x{k} exceeds the "
                         f"{SMEM_OPTIN_BYTES - HF_TABLE_OFFSET} bytes of "
                         "shared memory a block stages")
    if (m * k) % 4 or table.data_ptr() % 16:
        raise ValueError("hop_fused: the table must start on 16 bytes and "
                         "hold a multiple of 4 floats per query")


def _check_code_rows(codes, m) -> None:
    """Rows of M = 4, 8, 16, 32 or 64 codes are read by vector loads (one,
    or two or four of 16 bytes), which need the rows' start aligned to the
    load's width."""
    width = _ROW_ALIGN.get(m, 1)
    if codes.data_ptr() % width:
        raise ValueError(f"hop_fused: code rows of {m} bytes must start on "
                         f"{width} bytes")


def hop_fused(codes_slab, blooms, buckets, in_merged, table, scalars,
              or_masks, range_field, bucket_lo, bucket_hi):
    """Fused hop candidate pass (B, C) slab -> (key (B, C) f32, ok (B, C)
    bool); see ``ref.hop_fused_ref`` for the layout."""
    if not codes_slab.is_cuda:
        return ref.hop_fused_ref(codes_slab, blooms, buckets, in_merged,
                                 table, scalars, or_masks, range_field,
                                 bucket_lo, bucket_hi)
    dev = codes_slab.device
    b, c, m = codes_slab.shape
    f = buckets.shape[-1]
    _check("codes_slab", codes_slab, torch.uint8, (b, c, m), dev)
    _check("blooms", blooms, torch.int32, (b, c), dev)
    _check("buckets", buckets, torch.int32, (b, c, f), dev)
    _check("in_merged", in_merged, torch.bool, (b, c), dev)
    _check_hop_params(b, m, table, scalars, or_masks, range_field, bucket_lo,
                      bucket_hi, dev)
    _check_code_rows(codes_slab, m)
    key = torch.empty((b, c), dtype=torch.float32, device=dev)
    ok = torch.empty((b, c), dtype=torch.bool, device=dev)
    _launch("hop_fused_launch", codes_slab.data_ptr(), blooms.data_ptr(),
            buckets.data_ptr(), in_merged.data_ptr(), table.data_ptr(),
            scalars.data_ptr(), or_masks.data_ptr(), range_field.data_ptr(),
            bucket_lo.data_ptr(), bucket_hi.data_ptr(), key.data_ptr(),
            ok.data_ptr(), b, c, m, table.shape[-1], f, or_masks.shape[-1],
            range_field.shape[-1], _stream(dev))
    _count("hop_fused")
    return key, ok


def hop_fused_gather(codes, blooms, buckets, merged_words, ids, table,
                     scalars, or_masks, range_field, bucket_lo, bucket_hi):
    """The fused hop pass gathering its own candidate rows: codes (N, M)
    uint8, blooms (N,) int32, buckets (N, F) int32 (the stores as
    ``selectors.kernel_view`` gives them), merged_words (B, NW) int32 rare-
    list bitmaps with NW * 32 >= N, ids (B, C) int32 -> (key (B, C) f32,
    ok (B, C) bool), equal to ``hop_fused`` on the slab ``codes[ids]``,
    ``blooms[ids]``, ``buckets[ids]``, bit ``ids`` of ``merged_words``. An
    id outside [0, N) gives key +inf and ok False. Launches count under
    ``hop_fused``."""
    n, m = codes.shape
    nw = merged_words.shape[-1]
    if nw * 32 < n:
        raise ValueError(f"hop_fused_gather: {nw} bitmap words do not "
                         f"cover {n} ids")
    if not codes.is_cuda:
        return ref.hop_fused_gather_ref(codes, blooms, buckets, merged_words,
                                        ids, table, scalars, or_masks,
                                        range_field, bucket_lo, bucket_hi)
    dev = codes.device
    b, c = ids.shape
    f = buckets.shape[-1]
    _check("codes", codes, torch.uint8, (n, m), dev)
    _check("blooms", blooms, torch.int32, (n,), dev)
    _check("buckets", buckets, torch.int32, (n, f), dev)
    _check("merged_words", merged_words, torch.int32, (b, nw), dev)
    _check("ids", ids, torch.int32, (b, c), dev)
    _check_hop_params(b, m, table, scalars, or_masks, range_field, bucket_lo,
                      bucket_hi, dev)
    _check_code_rows(codes, m)
    key = torch.empty((b, c), dtype=torch.float32, device=dev)
    ok = torch.empty((b, c), dtype=torch.bool, device=dev)
    _launch("hop_fused_gather_launch", codes.data_ptr(), blooms.data_ptr(),
            buckets.data_ptr(), merged_words.data_ptr(), ids.data_ptr(),
            table.data_ptr(), scalars.data_ptr(), or_masks.data_ptr(),
            range_field.data_ptr(), bucket_lo.data_ptr(),
            bucket_hi.data_ptr(), key.data_ptr(), ok.data_ptr(), n, nw, b, c,
            m, table.shape[-1], f, or_masks.shape[-1], range_field.shape[-1],
            _stream(dev))
    _count("hop_fused")
    return key, ok


def or_scatter(words, slots):
    """Word-packed bitmap OR-scatter (B, NW) x (B, C) -> (B, NW), out of
    place (``repro.kernels.ops.or_scatter``'s contract). Slots < 0 or
    >= NW*32 are dropped. The search path calls :func:`or_scatter_` and
    :func:`or_scatter_new` instead."""
    if not words.is_cuda:
        return ref.or_scatter_ref(words, slots)
    dev = words.device
    b, nw = words.shape
    c = slots.shape[-1]
    _check("words", words, torch.int32, (b, nw), dev)
    _check("slots", slots, torch.int32, (b, c), dev)
    out = torch.empty_like(words)
    _launch("or_scatter_launch", words.data_ptr(), slots.data_ptr(),
            out.data_ptr(), b, nw, c, _stream(dev))
    _count("or_scatter")
    return out


def _slot_shift(n_ids) -> int:
    """The kernels' slot rule: 0 when the slots are the ids themselves
    (``n_ids`` None, or a visited table that holds every id), else the
    shift of the visited table's multiply-shift hash (always >= 12)."""
    if n_ids is None:
        return 0
    n_slots, shift = ref.visited_spec(n_ids)
    return 0 if n_slots >= n_ids else shift


def or_scatter_(words, ids, n_ids=None):
    """In place: for every ``ids[b, j] >= 0`` set the bit of its slot in
    row b of ``words`` (B, NW) int32, and return ``words``. The slot is the
    id itself, or with ``n_ids`` its visited-table slot
    (``ref.visited_slot``); slots >= NW*32 are dropped. ids (B, C) int32.
    C = 0 launches nothing; launches count under ``or_scatter``."""
    if not words.is_cuda:
        return ref.or_scatter_ref_(words, ids, n_ids)
    dev = words.device
    b, nw = words.shape
    c = ids.shape[-1]
    _check("words", words, torch.int32, (b, nw), dev)
    _check("ids", ids, torch.int32, (b, c), dev)
    if b * c:
        _launch("or_scatter_inplace_launch", words.data_ptr(),
                ids.data_ptr(), b, nw, c, _slot_shift(n_ids), _stream(dev))
        _count("or_scatter")
    return words


def or_scatter_new(ids, nw: int, n_ids=None):
    """A fresh (B, nw) int32 table, zero but for the bits of the slots of
    ``ids`` (B, C) int32 (as in :func:`or_scatter_`): ``torch.zeros`` and
    the in-place kernel, one launch counted under ``or_scatter`` when C >
    0 (csrc/or_scatter.cu says why it has no kernel of its own)."""
    if not ids.is_cuda:
        return ref.or_scatter_new_ref(ids, nw, n_ids)
    words = torch.zeros((ids.shape[0], nw), dtype=torch.int32,
                        device=ids.device)
    return or_scatter_(words, ids, n_ids)


def prune_scan(dp_s, dcc_s, a2: float, r: int):
    """RobustPrune domination scan (B, C) + (B, C, C) -> (B, C) keep mask."""
    if not dp_s.is_cuda:
        return ref.prune_scan_ref(dp_s, dcc_s, float(a2), int(r))
    dev = dp_s.device
    b, c = dp_s.shape
    _check("dp_s", dp_s, torch.float32, (b, c), dev)
    _check("dcc_s", dcc_s, torch.float32, (b, c, c), dev)
    if c > 1024:
        raise ValueError(f"prune_scan: {c} candidates exceed 1024 (32 "
                         "columns for each lane of a warp)")
    keep = torch.empty((b, c), dtype=torch.bool, device=dev)
    _launch("prune_scan_launch", dp_s.data_ptr(), dcc_s.data_ptr(),
            keep.data_ptr(), b, c, float(a2), int(r), _stream(dev))
    _count("prune_scan")
    return keep


def _check_pq(codes, table, dev) -> str:
    """The inputs of both ``pq_scan`` entries; returns the code type's
    suffix of the launch function."""
    n, m = codes.shape
    k = table.shape[-1]
    if codes.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"codes: dtype {codes.dtype}, expected uint8 or "
                        "int32")
    _check("codes", codes, codes.dtype, (n, m), dev)
    _check("table", table, torch.float32, (m, k), dev)
    if m * k * 4 > SMEM_OPTIN_BYTES:
        raise ValueError(f"pq_scan: table of {m}x{k} exceeds the "
                         f"{SMEM_OPTIN_BYTES} bytes of shared memory a "
                         "block stages")
    return "u8" if codes.dtype == torch.uint8 else "i32"


def pq_scan(codes, table):
    """ADC distances of N code rows against one table: codes (N, M) uint8 or
    int32, table (M, K) float32 -> (N,) float32; see ``ref.pq_scan_ref``.
    N = 0 launches nothing."""
    if not codes.is_cuda:
        return ref.pq_scan_ref(codes, table)
    dev = codes.device
    kind = _check_pq(codes, table, dev)
    n, m = codes.shape
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _launch(f"pq_scan_{kind}_launch", codes.data_ptr(), table.data_ptr(),
            out.data_ptr(), n, m, table.shape[-1], _stream(dev))
    _count("pq_scan")
    return out


def pq_scan_gather(codes, ids, table):
    """``pq_scan`` of the rows ``ids`` (C,) int32 names in the store codes
    (N, M), gathered by the kernel itself: -> (C,) float32, equal to
    ``pq_scan(codes[ids], table)``; an id outside [0, N) gives +inf. See
    ``ref.pq_scan_gather_ref``. C = 0 launches nothing; launches count
    under ``pq_scan``."""
    if not codes.is_cuda:
        return ref.pq_scan_gather_ref(codes, ids, table)
    dev = codes.device
    kind = _check_pq(codes, table, dev)
    n, m = codes.shape
    c = ids.shape[0]
    _check("ids", ids, torch.int32, (c,), dev)
    out = torch.empty((c,), dtype=torch.float32, device=dev)
    if c == 0:
        return out
    _launch(f"pq_scan_gather_{kind}_launch", codes.data_ptr(),
            ids.data_ptr(), table.data_ptr(), out.data_ptr(), c, n, m,
            table.shape[-1], _stream(dev))
    _count("pq_scan")
    return out


def _as_bits(name: str, t: torch.Tensor) -> torch.Tensor:
    """A uint32 or int32 tensor of 32-bit words as its int32 view."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected uint32 or int32")
    return t


def approx_probe(blooms, buckets, or_masks, params):
    """Single-field approximate-membership probe over N candidates
    (the counterpart of ``repro.kernels.ops.approx_probe``): blooms (N,)
    uint32/int32, buckets (N,) uint8/int32, or_masks (QL <= 8,)
    uint32/int32, params (8,) int32 -> (N,) bool; see
    ``ref.approx_probe_ref`` for the param block. N = 0 launches nothing."""
    if not blooms.is_cuda:
        return ref.approx_probe_ref(blooms, buckets, or_masks, params)
    dev = blooms.device
    n = blooms.shape[0]
    ql = or_masks.shape[0]
    bl = _as_bits("blooms", blooms)
    om = _as_bits("or_masks", or_masks)
    _check("blooms", bl, torch.int32, (n,), dev)
    if buckets.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"buckets: dtype {buckets.dtype}, expected uint8 or "
                        "int32")
    _check("buckets", buckets, buckets.dtype, (n,), dev)
    _check("or_masks", om, torch.int32, (ql,), dev)
    _check("params", params, torch.int32, (8,), dev)
    if ql > 8:
        raise ValueError(f"approx_probe: {ql} OR masks exceed 8")
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = "approx_probe_u8_launch" if buckets.dtype == torch.uint8 \
        else "approx_probe_i32_launch"
    _launch(fn, bl.data_ptr(), buckets.data_ptr(), om.data_ptr(),
            params.data_ptr(), out.data_ptr(), n, ql, _stream(dev))
    _count("approx_probe")
    return out


def l2_rerank(vecs, query):
    """Squared L2 distances |v|^2 - 2 v.q + |q|^2 of one query to B rows
    (the counterpart of ``repro.kernels.ops.l2_rerank``): vecs (B, D)
    float32, query (D,) float32 -> (B,) float32. B = 0 launches nothing."""
    if not vecs.is_cuda:
        return ref.l2_rerank_ref(vecs, query)
    dev = vecs.device
    b, d = vecs.shape
    _check("vecs", vecs, torch.float32, (b, d), dev)
    _check("query", query, torch.float32, (d,), dev)
    if d * 4 > 48 * 1024:
        raise ValueError(f"l2_rerank: a query of {d} floats exceeds 48 KB "
                         "of shared memory")
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    _launch("l2_rerank_launch", vecs.data_ptr(), query.data_ptr(),
            out.data_ptr(), b, d, _stream(dev))
    _count("l2_rerank")
    return out

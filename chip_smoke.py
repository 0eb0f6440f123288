#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. kernels — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a), calls each wrapper on card tensors at the main path's
   shapes and holds it against its plain PyTorch version on the same inputs
   (hop_fused key and pq_scan distances bit-identical, hop_fused ok equal,
   or_scatter words equal, prune_scan keep mask equal), and times both with
   CUDA events; for pq_scan also one PyTorch call that computes the same
   function (``embedding_bag``), timed as a yardstick and used nowhere else.
   hop_fused is held in both entries: the slab and the gathered one (ids
   over stores of 1M rows, which the hop step launches); or_scatter in all
   three: the out-of-place slab entry (``or_scatter/visited``,
   ``or_scatter/rare_list``), the in-place entry the hop launches
   (``or_scatter/visited_inplace``) and the fresh-table entry of the
   seeding (``or_scatter/visited_new``, ``or_scatter/rare_list_new``:
   ``torch.zeros`` and the in-place kernel);
   prune_scan also on rows where nothing prunes (every row keeps
   r = 32). pq_scan is timed on the gated scan's 1M rows
   (``pq_scan/scan``, and ``pq_scan/scan_cold`` with the L2 evicted
   before each call), on 50,000 pre-route rows through
   the slab entry (``pq_scan/pre``) and on 50,000 ids over the 1M-row store
   through the gathered entry the pre route launches
   (``pq_scan/pre_gather``); approx_probe at 100,000 and 1M rows, and at
   1M with the L2 evicted (``approx_probe/1M_cold``). At M = 64 (a 64 KB
   table, staged past the 48 KB default by the kernels' opt-in) the
   gathered hop_fused is held at (64, 512) with two bucket fields and range
   slots over both (``hop_fused/gather/M64``), and pq_scan on 1M rows
   (``pq_scan/scan/M64``) and on 50,000 ids over them
   (``pq_scan/pre_gather/M64``), from a generator of their own.
   ``launch_floor`` is
   the device time of one launch that reads nothing and writes 4 bytes
   (PyTorch's fill of one int32), with a one-row ``approx_probe`` beside
   it (``launch_floor/approx_probe``, the floor of earlier runs).
3. card vs CPU — builds an index on the card over the test corpus, copies
   it to the CPU with ``FilteredANNEngine.from_arrays`` and runs the same
   label / range / hybrid queries on both: routes, ids and integer counters
   equal, distances allclose. The same for an ``Index`` built on the card
   from metadata dicts: ``search_batch`` and ``approx_scan_batch`` under
   DSL filters, card against CPU.
4. full size — the main path at a deployment's data size: the index build
   (PQ, Vamana passes, 2-hop lists, record store) and filtered search under
   the speculative and post policies, with recall against brute force on
   the card and every returned id checked by exact membership; each pre
   query calls ``ops.pq_scan_gather`` once and nothing calls the slab
   ``ops.pq_scan``; every ``or_scatter`` launch goes through the in-place
   ``ops.or_scatter_``, from the hop or from the seeding's
   ``ops.or_scatter_new``, and nothing calls the slab ``ops.or_scatter``. Kernel launch counts
   are zeroed just before the build and read just after the last
   ``engine.search`` run; the diagnostics between them (graph stats,
   greedy recall, the hop-loop profile) and each run's result checks are
   left out of the counts.
5. serving — the phase-4 engine behind ``Index`` and ``SearchServer``:
   warmup over every degrade rung (the gated scan included), the affine
   service model's calibration, a burst of DSL requests that walks the
   queue up the ladder (every handle resolves or fails with ``Overloaded``
   / ``DeadlineExceeded``, every returned id passes exact membership), then
   ``approx_scan_batch`` alone on the 64 queries (QPS, pages, recall@10
   against brute force on the card; one slab ``ops.pq_scan`` call and
   launch per query) and 8 of them against a CPU copy of the engine.
   Launch counts are zeroed just before the warmup and read just after the
   scan batch.
6. ops — ``kernels.ops.approx_probe`` and ``ops.l2_rerank`` (the
   counterparts of ``repro.kernels.ops``) over the whole corpus for each of
   the 64 phase-4 queries: the probe, with a param block built from the
   port's Bloom masks and bucket bounds, equals its plain version and
   admits every record that exact membership admits; the re-rank's top 10
   equals brute force's up to
   exact-distance ties. Launch counts are zeroed just before and read just
   after.
7. lifecycle — the phase-5 ``Index`` is saved under ``build/`` (free and
   written bytes, seconds), loaded back on the card (the label batch
   answers equal) and loaded again with ``shards=2`` (its label batch equal
   to the unsharded reload's), grows by 10,000 inserted records (ids contiguous from N,
   ``prune_scan`` launched), and serves the label batch under the fault
   plan ``rate=0.1,seed=7`` (faults, retries, degraded, recall against the
   clean batch; every id of an undegraded query passes exact membership).
8. disk — the same engine (after phase 7's inserts) spilled with
   ``to_disk`` to slab files under ``build/`` (write seconds, file and stub
   bytes), then, on the disk backend, what ran on the device backend just
   before the spill: the phase-4 label batch under the post, strict_in,
   speculative (pre and spec_in routes) and strict_pre policies, the
   phase-7 label batch under the fault plan, and 8 scan-rung requests
   through ``approx_scan_batch``. Ids, distances, routes and integer
   counters must equal the device backend's, and each run must launch the
   same kernels through the same ``ops`` entries; every hop step is a
   graph replay with the disk fetch between the graphs, but those of the
   strict_in and fault-plan runs (eager). Per run: pages/query
   modeled and measured, the page cache's hit rate, read-ahead pages,
   attribute probes, gated skips and reads, p50/p95 µs per page; the
   speculative run again on a fresh store after ``fsync`` and
   ``posix_fadvise(DONTNEED)`` dropped the file from the OS page cache
   (the fall in ``/proc/meminfo``'s ``Cached`` printed beside it). The
   slabs are deleted after.
9. oracles — run after phase 6, on the engine as phase 4 built it (phase
   7's inserts grow the stores past 2**20 rows, where the visited set
   hashes): ``filtered_search`` against the naive oracle
   ``filtered_search_ref`` under post, spec_in and strict_in on the label
   batch and a 30% range batch (io_pages, explored, hops and n_valid equal
   per query, recall@10 within 0.01; seconds of each side and PyTorch
   calls per hop of each); ``distance_fn=ops.pq_scan`` through the
   compacting driver and through the oracle, each equal on every field to
   its default-distance run (``pq_scan`` launches per hop step); the
   pre-fused ``filtered_search_legacy`` against the compacting driver
   under post and spec_in (ms per batch, recall@10, exact membership of
   every id); ``collect_trace=True`` (equal to the untraced run, the trace
   printed); and the sequential reference builder beside the batched one
   on BENCH_build.json's corpus (n=12,000, d=48; seconds, greedy
   recall@10, batched ≥ reference − 0.01).
10. shard — run after phase 9, on the same engine: every phase-4 batch
   through ``engine.shard(2)`` and the label batch under the speculative
   and strict_in policies through ``engine.shard(4)``, each equal per query
   (ids, routes, counters, distances bit for bit) to an unsharded run made
   beside it (seconds per batch, hop steps and ``hop_fused`` /
   ``or_scatter`` launches per hop step of both); PyTorch calls per hop
   sharded and unsharded and the device memory each runner added; the
   PQ-navigated ``FilteredANNEngine.build(shards=2)`` on the phase-4 corpus
   (``nav_prune_s`` / ``scatter_s``, greedy recall@10 and the share
   reachable from the medoid beside phase 4's build; halved, not below
   250,000 rows, while the smoke would pass 1,000 s) and
   ``build_vamana_sharded`` at S = 4 with exact navigation on the first
   100,000 rows, element for element ``build_vamana_batched`` on them. ``hop_fused_gather``, ``or_scatter_``
   and ``prune_scan`` must launch.
11. lm — run after phase 9 and before phase 10 (whose build cut reads the
   clock): the LM serving path (``repro_torch.models``, ``serve.decode``,
   ``launch.serve``), float32 checks with TF32 off (PyTorch's default,
   asserted). ``lm_card_vs_cpu``: each of the ten archs' smoke configs on
   the card against the CPU with the same weights (logits within 1e-4),
   and prefill + decode against the forward on the card (within 2e-3) for
   qwen2-7b, mamba2-2.7b, jamba-v0.1-52b, mixtral-8x22b and mixtral's
   sliding-window ring. ``lm_full``: qwen2-1.5b (28 layers) and
   mamba2-2.7b (64 layers) at their published widths, mixtral-8x22b at its
   widths cut to 2 layers: prefill + decode against the forward in
   float32 (mixtral drop-free at capacity factor 8, prefilled 5,120 tokens
   past its 4,096 window), qwen's blockwise attention against full at
   s = 4,096, and a timed ``launch.serve.main`` run each in the configs'
   bfloat16 compute (8 requests × 512 prompt tokens × 32 new: prefill
   seconds, decode ms/token, PyTorch calls a step, the step's bytes
   bound, peak memory; mixtral's at capacity factor 1.25 with its
   drop_frac). ``rag``: 16 DSL requests (label, range, hybrid, Tag ∧ Num)
   through a ``RetrievalFrontend`` on the phase-5 ``Index``, flushed once,
   every match checked against the source arrays, then greedy
   ``generate`` of 16 tokens per request on qwen2-1.5b in bfloat16 from
   prompts built with ``context_tokens`` (one batch per prompt length);
   the retrieval's launches are phase 11's.
12. train — after phase 11, before phase 10: the LM training path
   (``repro_torch.train``, ``data.tokens``/``pipeline``,
   ``launch.train``), float32 checks with TF32 off.
   ``train_card_vs_cpu``: qwen2-1.5b, mamba2-2.7b and mixtral-8x22b smoke
   configs from the same weights, card against CPU: loss and every
   gradient leaf, and the parameters after one AdamW step with float32 and
   with int8 moments (within 1e-4); ``compressed_psum_grads`` at S = 4,
   threefry draws and sampled ``generate`` equal to the CPU's.
   ``train_full``: ``launch.train.main --mesh local`` on qwen2-1.5b at its
   published widths (float32 parameters, bfloat16 compute, remat), 4 × 512
   tokens a step, 8 steps, no save: the mesh and its per-device parameter
   bytes, losses finite and falling, step seconds
   (median from the second step), tokens/s, PyTorch calls a step (counted
   on the CPU at the real depth and tiny widths), peak memory, and the
   step's bound 8 · params · tokens at 989 TFLOP/s. ``train_resume``: 6
   smoke-width steps with a checkpoint every 2 and step 5 failing once
   end with the parameters of an uninterrupted run, and the step-4
   checkpoint restores into a fresh model. Its launches (none: no kernel
   lies on this path) are counted as phase 12's.
13. mesh — after phase 12, before phase 10: the mesh and launch tooling
   (``launch.mesh``, ``launch.shardings``, ``serve.sp_attention``,
   ``launch.roofline``, ``launch.dryrun``, ``launch.dryrun_ann``).
   ``sp_decode``: qwen2-1.5b at its published widths, 8 requests × 512
   prompt tokens into caches of 32,768 slots, 16 greedy new tokens, the
   plain decode and then ``sp_decode=True`` under ``make_local_mesh(1,
   4)``: in float32 (TF32 off) tokens equal and every step's logits within
   2e-3, every attention layer of every step through the split-K core; in
   the config's bfloat16 ms/token of both, PyTorch calls a step and the
   step's bytes bound. ``dryrun``: ``launch.dryrun.run_cell("qwen2-1.5b",
   "decode_32k", "single")`` and ``launch.dryrun_ann.run("single")`` on
   ``meta``, status ok, with their per-card bytes and roofline terms
   (analytic, at the H100 SXM data sheet's rates). Its launches (none) are
   counted as phase 13's.

14. wide (runs right after phase 3) — the benchmark's LAION-shaped range
   cell (d 768, PQ M 64, numeric fields width and similarity) cut to
   50,000 records, built on the card through ``annbench``'s
   ``build_index``; 64 of its range requests through
   ``Index.search_batch`` (exact membership of every id, one
   ``ops.pq_scan_gather`` call a ``pre`` row), then those routed ``in``
   alone over 5 counted batches: one ``hop_fused`` launch a hop step, each
   through ``ops.hop_fused_gather``, every hop step a graph replay.

Phase 2 also times ``hop_fused_gather`` at the shard widths B = 32 and 16
and ``prune_scan`` on 512 and 256 of its 1024 rows (one shard's prune at
S = 2 and 4), and covers approx_probe and l2_rerank (the latter against its
plain version within rtol=1e-5, atol=1e-5·max(|v|²+|q|²), and with
``torch.cdist(vecs, q[None]).square()`` timed as its yardstick); phase 3
also inserts the same batch on the card and on the CPU copy, runs the
fault plan on both and saves on the card to load on the CPU.

Then a ``kernels`` line (launches of hop_fused, or_scatter and prune_scan
from phase 4 (each row also lists its launches in every phase, phases 8's
to 14's included, and the line its ``hop_fused_gather``, ``or_scatter_`` and
``pq_scan_gather`` calls in phase 8 and phase 14's hop_fused launches a hop
step), of pq_scan from phase 5, of approx_probe and l2_rerank from
phase 6; times from phase 2: hop_fused's of the gathered entry with the slab
entry's, the shard-width and the M = 64 rows beside it, or_scatter's of the
in-place entry with the fresh-table and slab rows beside it, prune_scan's
with the no-prune and shard-width rows beside it, pq_scan's with its cold,
pre, pre_gather and M = 64 rows beside it,
approx_probe's with its cold and 100,000-row rows beside it, and both
launch floors), the card's
name and power limit as ``nvidia-smi`` prints them, and last the result
line. It exits non-zero, printing no result, when there is no CUDA device
or the port's sources are missing; any failed check raises.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FULL_N = 1_000_000
MIN_N = 250_000
TIME_LIMIT_S = 1200.0           # the smoke's limit, kernel builds included
MARGIN_S = 150.0
# seconds of the full-size, serving, ops, lifecycle, disk and oracle phases
# per corpus row, scaled linearly: at N=1M on an NVIDIA H100 80GB HBM3 at
# 700 W the full-size phase took 217-394 s, the serving phase 29-56 s, the
# ops and lifecycle phases ~50-150 s and the disk phase ~55 s (its 8.3 GB
# of slabs, written in ~10 s): ~560 s at most, the whole smoke 416-540 s
# with its ~85 s of kernel and card-vs-CPU phases; the oracle phase adds
# up to ~250 s (PERF.md §6, PR 18); host time varies by up to 40% between
# machines. Phase 10 (~340 s at N=1M) is left out: it cuts its own build
# instead (SHARD_BUILD_MIN_N)
FULL_S_PER_ROW = 900.0 / 1_000_000


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 21, per_rep: int = 10) -> tuple[float, float]:
    """(device_ms, call_ms) of one call of ``fn``, medians over ``reps``.

    device_ms: the stream is first held busy (``torch.cuda._sleep``) so the
    host enqueues ``per_rep`` calls ahead of the card, and CUDA events then
    time them back to back — the card's time without host dispatch gaps.
    call_ms: one call between CUDA events on an idle stream — what a caller
    waits for, host dispatch included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev_t, call_t = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(per_rep):
            fn()
        b.record()
        b.synchronize()
        dev_t.append(a.elapsed_time(b) / per_rep)
        a.record()
        fn()
        b.record()
        b.synchronize()
        call_t.append(a.elapsed_time(b))
    return (float(sorted(dev_t)[reps // 2]), float(sorted(call_t)[reps // 2]))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(kernel, plain, **row) -> dict:
    """A kernels_vs_plain row: the kernel's and the plain version's times."""
    row["ms"], row["call_ms"] = time_ms(kernel)
    row["plain_ms"], row["plain_call_ms"] = time_ms(plain)
    return row


def time_cold_ms(fn, scratch, reps: int = 21) -> float:
    """Device ms of one call of ``fn`` that finds the L2 cache cold, median
    over ``reps``: before each call a write of ``scratch`` (more bytes than
    the 50 MB L2 holds) evicts what the call reads, and one call runs
    between a pair of CUDA events. The stream is held busy first, so the
    host's enqueue leaves no gap between the write and the call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        scratch.fill_(float(i))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(sorted(ts)[reps // 2])


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_phase(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import build, ops, ref

    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    out = {}

    # hop_fused: B=64 queries, W·(R+R_d) = 512 candidates, M=16, K=256,
    # F=1, QL=8, NR=4
    b, c, m, k, f, ql, nr = 64, 512, 16, 256, 1, 8, 4
    args = [
        rng.integers(0, k, (b, c, m)).astype(np.uint8),
        rng.integers(-2 ** 31, 2 ** 31, (b, c), dtype=np.int64)
        .astype(np.int32),
        rng.integers(0, 256, (b, c, f)).astype(np.int32),
        rng.integers(0, 2, (b, c)).astype(bool),
        (rng.normal(0, 1, (b, m, k)) ** 2).astype(np.float32),
        np.stack([rng.integers(0, 2 ** 16, b), rng.integers(0, 3, b),
                  rng.integers(0, 3, b), rng.integers(0, 2, b)],
                 axis=1).astype(np.int32),
        rng.integers(0, 2 ** 12, (b, ql)).astype(np.int32),
        np.where(rng.random((b, nr)) < 0.5, 0, -1).astype(np.int32),
        rng.integers(0, 128, (b, nr)).astype(np.int32),
        rng.integers(128, 256, (b, nr)).astype(np.int32),
    ]
    targs = [torch.from_numpy(a).to(dev) for a in args]
    key_k, ok_k = ops.hop_fused(*targs)
    key_p, ok_p = ref.hop_fused_ref(*targs)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p), "hop_fused: ok differs"
    assert torch.equal(key_k.view(torch.int32), key_p.view(torch.int32)), \
        "hop_fused: key not bit-identical"
    nbytes = (b * c * m + b * c * 4 + b * c * f * 4 + b * c + b * m * k * 4
              + b * (4 + ql + 3 * nr) * 4 + b * c * 4 + b * c)
    bms, by = bound(nbytes, b * c * m)
    out["hop_fused"] = timed(
        lambda: ops.hop_fused(*targs), lambda: ref.hop_fused_ref(*targs),
        shape=[b, c, m], max_abs_err=float((key_k - key_p).abs().max()),
        bound_ms=bms, bound_by=by)

    # hop_fused, the gathered entry the hop step launches: the same shape,
    # ids drawn uniformly over stores of N = 1,000,000 rows and a rare-list
    # bitmap of ceil((N+1)/32) words per query
    n = 1_000_000
    nw = (n + 1 + 31) // 32
    gargs = [
        torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8)),
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                         .astype(np.int32)),
        torch.from_numpy(rng.integers(0, 256, (n, f)).astype(np.int32)),
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                                      dtype=np.int64).astype(np.int32)),
        torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)),
    ]
    gargs = [a.to(dev) for a in gargs] + targs[4:]
    key_k, ok_k = ops.hop_fused_gather(*gargs)
    key_p, ok_p = ref.hop_fused_gather_ref(*gargs)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p), "hop_fused/gather: ok differs"
    assert torch.equal(key_k.view(torch.int32), key_p.view(torch.int32)), \
        "hop_fused/gather: key not bit-identical"
    # ids, the gathered rows (code row, bloom word, bucket words), one
    # rare-list word per candidate, the tables and parameters, the outputs
    nbytes = (b * c * 4 + b * c * (m + 4 + 4 * f) + b * c * 4
              + b * m * k * 4 + b * (4 + ql + 3 * nr) * 4 + b * c * 5)
    bms, by = bound(nbytes, b * c * m)
    out["hop_fused/gather"] = timed(
        lambda: ops.hop_fused_gather(*gargs),
        lambda: ref.hop_fused_gather_ref(*gargs), shape=[b, c, m, n],
        max_abs_err=float((key_k - key_p).abs().max()), bound_ms=bms,
        bound_by=by)
    # the same at the shard widths of phase 10: each of S = 2 (4) shards
    # launches it on its B/S = 32 (16) query rows
    for bs in (32, 16):
        sub = gargs[:3] + [a[:bs] for a in gargs[3:]]
        key_k, ok_k = ops.hop_fused_gather(*sub)
        key_p, ok_p = ref.hop_fused_gather_ref(*sub)
        torch.cuda.synchronize()
        assert torch.equal(ok_k, ok_p) and torch.equal(
            key_k.view(torch.int32), key_p.view(torch.int32)), \
            f"hop_fused/gather/B{bs} differs"
        bms, by = bound(nbytes * bs / b, bs * c * m)
        out[f"hop_fused/gather/B{bs}"] = timed(
            lambda: ops.hop_fused_gather(*sub),
            lambda: ref.hop_fused_gather_ref(*sub), shape=[bs, c, m, n],
            max_abs_err=float((key_k - key_p).abs().max()), bound_ms=bms,
            bound_by=by)
    del gargs, sub

    # or_scatter: the visited set at N=1M (64, 32768 words) with one hop's
    # W·R = 32 slots, and the rare-list bitmap (64, ceil((N+1)/32)) with
    # CAP = 2048 slots
    for tag, (b, nw, c) in (("visited", (64, 32768, 32)),
                            ("rare_list", (64, 31251, 2048))):
        words = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (b, nw), dtype=np.int64).astype(np.int32)
        ).to(dev)
        slots = torch.from_numpy(rng.integers(
            -8, nw * 32 + 8, (b, c)).astype(np.int32)).to(dev)
        got = ops.or_scatter(words, slots)
        want = ref.or_scatter_ref(words, slots)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"or_scatter ({tag}) differs"
        bms, by = bound(2 * b * nw * 4 + b * c * 4, b * c)
        out[f"or_scatter/{tag}"] = timed(
            lambda: ops.or_scatter(words, slots),
            lambda: ref.or_scatter_ref(words, slots), shape=[b, nw, c],
            max_abs_err=float((got.long() - want.long()).abs().max()),
            bound_ms=bms, bound_by=by)

    # or_scatter, the two entries the search path launches (inputs from
    # their own generator, so the other rows keep theirs): the hop's
    # in-place visited update, (64, 32768 words) with one hop's W·R = 32 ids
    # over N = 1M (identity slots), timed on one table over and over (an OR
    # into a set bit moves the same bytes), and the plain version on a
    # clone; the visited set seeded with E = 1 entry a query; the rare-list
    # bitmap at N = 1M, (64, 31251 words) from CAP = 2048 ids
    orng = np.random.default_rng(16)
    n_ids = 1_000_000
    b, nw, c = 64, 32768, 32
    words = torch.from_numpy(orng.integers(
        -2 ** 31, 2 ** 31, (b, nw), dtype=np.int64).astype(np.int32)).to(dev)
    ids = torch.from_numpy(orng.integers(-1, n_ids, (b, c)).astype(
        np.int32)).to(dev)
    got = ops.or_scatter_(words.clone(), ids, n_ids)
    want = ref.or_scatter_ref_(words.clone(), ids, n_ids)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "or_scatter/visited_inplace differs"
    # per id: the id, and one 32-byte sector read and written back in L2
    bms, by = bound(b * c * (4 + 32), b * c)
    out["or_scatter/visited_inplace"] = timed(
        lambda: ops.or_scatter_(words, ids, n_ids),
        lambda: ref.or_scatter_ref_(words.clone(), ids, n_ids),
        shape=[b, nw, c], max_abs_err=float((got.long()
                                             - want.long()).abs().max()),
        bound_ms=bms, bound_by=by)
    for tag, (b, nw, c), nid in (("visited_new", (64, 32768, 1), n_ids),
                                 ("rare_list_new", (64, 31251, 2048), None)):
        ids = torch.from_numpy(orng.integers(
            -1, min(nw * 32 + 8, n_ids + 1), (b, c)).astype(np.int32)).to(dev)
        got = ops.or_scatter_new(ids, nw, nid)
        want = ref.or_scatter_new_ref(ids, nw, nid)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"or_scatter/{tag} differs"
        # the ids read once and the table written once
        bms, by = bound(b * nw * 4 + b * c * 4, b * c)
        out[f"or_scatter/{tag}"] = timed(
            lambda: ops.or_scatter_new(ids, nw, nid),
            lambda: ref.or_scatter_new_ref(ids, nw, nid), shape=[b, nw, c],
            max_abs_err=float((got.long() - want.long()).abs().max()),
            bound_ms=bms, bound_by=by)
    del words, ids

    # prune_scan: B=1024 rows, C = R+8 (overflow), ell+R pass 1 and pass 2
    for c in (40, 74, 96):
        for a2 in (1.0, 1.44):
            b = 1024
            dp = np.sort(rng.normal(2, 1, (b, c)).astype(np.float32) ** 2, 1)
            dp[:, c - c // 5:] = np.inf
            dcc = rng.normal(0, 1, (b, c, c)).astype(np.float32) ** 2
            dcc = (dcc + dcc.transpose(0, 2, 1)) / 2
            dcc[:, np.arange(c), np.arange(c)] = 0.0
            tdp, tdcc = (torch.from_numpy(x).to(dev) for x in (dp, dcc))
            got = ops.prune_scan(tdp, tdcc, a2, 32)
            want = ref.prune_scan_ref(tdp, tdcc, a2, 32)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"prune_scan C={c} a2={a2}"
            kept = int(got.sum())
            bms, by = bound(b * c * 4 + kept * c * 4 + b * c, 2 * kept * c)
            out[f"prune_scan/C{c}/a2={a2}"] = timed(
                lambda: ops.prune_scan(tdp, tdcc, a2, 32),
                lambda: ref.prune_scan_ref(tdp, tdcc, a2, 32),
                shape=[b, c], kept=kept,
                max_abs_err=float((got.int() - want.int()).abs().max()),
                bound_ms=bms, bound_by=by)
            if (c, a2) != (96, 1.44):
                continue
            # the rows of one shard's prune in phase 10's sharded build:
            # B/S = 512 (S = 2) and 256 (S = 4) of a 1024-row batch
            for bs in (512, 256):
                sdp, sdcc = tdp[:bs], tdcc[:bs]
                got = ops.prune_scan(sdp, sdcc, a2, 32)
                want = ref.prune_scan_ref(sdp, sdcc, a2, 32)
                torch.cuda.synchronize()
                assert torch.equal(got, want), \
                    f"prune_scan C={c} a2={a2} B={bs}"
                kept = int(got.sum())
                bms, by = bound(bs * c * 4 + kept * c * 4 + bs * c,
                                2 * kept * c)
                out[f"prune_scan/C{c}/a2={a2}/B{bs}"] = timed(
                    lambda: ops.prune_scan(sdp, sdcc, a2, 32),
                    lambda: ref.prune_scan_ref(sdp, sdcc, a2, 32),
                    shape=[bs, c], kept=kept, max_abs_err=float(
                        (got.int() - want.int()).abs().max()),
                    bound_ms=bms, bound_by=by)

    # prune_scan where no lane prunes another (a2·dcc > dp off the
    # diagonal), so every row keeps r = 32: the disconnected build's case
    # and the longest chain of kept lanes
    b, c, a2 = 1024, 96, 1.44
    dp = np.sort(rng.uniform(1, 2, (b, c)).astype(np.float32), 1)
    dcc = (3 + np.abs(rng.normal(0, 1, (b, c, c)))).astype(np.float32)
    dcc[:, np.arange(c), np.arange(c)] = 0.0
    tdp, tdcc = (torch.from_numpy(x).to(dev) for x in (dp, dcc))
    got = ops.prune_scan(tdp, tdcc, a2, 32)
    want = ref.prune_scan_ref(tdp, tdcc, a2, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "prune_scan (no prune) differs"
    kept = int(got.sum())
    assert kept == 32 * b, f"prune_scan (no prune): {kept} kept"
    bms, by = bound(b * c * 4 + kept * c * 4 + b * c, 2 * kept * c)
    out["prune_scan/C96/noprune"] = timed(
        lambda: ops.prune_scan(tdp, tdcc, a2, 32),
        lambda: ref.prune_scan_ref(tdp, tdcc, a2, 32), shape=[b, c],
        kept=kept, max_abs_err=float((got.int() - want.int()).abs().max()),
        bound_ms=bms, bound_by=by)

    # what the card charges for one kernel launch: PyTorch's fill of one
    # element (one launch and one 4-byte store, nothing read, code no
    # redesign touches), and beside it approx_probe on one row (the floor
    # of earlier runs)
    cell = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms, floor_call_ms = time_ms(cell.zero_)
    out["launch_floor"] = {"via": "torch.Tensor.zero_ on one int32",
                           "ms": floor_ms, "call_ms": floor_call_ms}
    one = [torch.zeros(n, dtype=dt, device=dev)
           for n, dt in ((1, torch.int32), (1, torch.uint8), (8, torch.int32),
                         (8, torch.int32))]
    floor_ms, floor_call_ms = time_ms(lambda: ops.approx_probe(*one))
    out["launch_floor/approx_probe"] = {
        "via": "ops.approx_probe on one row", "ms": floor_ms,
        "call_ms": floor_call_ms}

    # writing it evicts the L2 before each cold-cache timing
    scratch = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)

    # pq_scan: the gated full-corpus scan (N = 1M rows, also with the L2
    # cold) and a pre-route candidate set (50,000 rows) through the slab
    # entry, and 50,000 ids over the 1M-row store through the gathered entry
    # the pre route launches; M=16 uint8 codes, K=256
    m, k = 16, 256
    for tag, n in (("scan", 1_000_000), ("pre", 50_000)):
        codes = torch.from_numpy(
            rng.integers(0, k, (n, m)).astype(np.uint8)).to(dev)
        table = torch.from_numpy(
            (rng.normal(0, 1, (m, k)) ** 2).astype(np.float32)).to(dev)
        got = ops.pq_scan(codes, table)
        want = ref.pq_scan_ref(codes, table)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"pq_scan ({tag}): not bit-identical"
        # the yardstick: one PyTorch call computing the same sums (in its
        # own order), its flat indices prepared outside the timed region
        flat_idx = codes.long() + torch.arange(m, device=dev) * k
        flat_table = table.reshape(-1, 1)

        def library():
            return torch.nn.functional.embedding_bag(flat_idx, flat_table,
                                                     mode="sum")

        lib = library()[:, 0]
        bms, by = bound(n * m + m * k * 4 + n * 4, n * m)
        row = timed(lambda: ops.pq_scan(codes, table),
                    lambda: ref.pq_scan_ref(codes, table), shape=[n, m, k],
                    max_abs_err=float((got - want).abs().max()),
                    bound_ms=bms, bound_by=by)
        row["library_ms"], row["library_call_ms"] = time_ms(library)
        row["library_max_abs_err"] = float((lib - want).abs().max())
        out[f"pq_scan/{tag}"] = row
        if tag == "scan":
            out["pq_scan/scan_cold"] = {
                "shape": [n, m, k], "bound_ms": bms, "bound_by": by,
                "ms": time_cold_ms(lambda: ops.pq_scan(codes, table),
                                   scratch)}
            store, store_table = codes, table

    c = 50_000
    ids = torch.from_numpy(
        rng.integers(0, store.shape[0], c).astype(np.int32)).to(dev)
    got = ops.pq_scan_gather(store, ids, store_table)
    want = ref.pq_scan_gather_ref(store, ids, store_table)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "pq_scan/pre_gather: not bit-identical"
    # the yardstick on the rows gathered outside the timed region
    flat_idx = store[ids.long()].long() + torch.arange(m, device=dev) * k
    flat_table = store_table.reshape(-1, 1)

    def library():
        return torch.nn.functional.embedding_bag(flat_idx, flat_table,
                                                 mode="sum")

    lib = library()[:, 0]
    # per id: the id, its code row, the distance out
    bms, by = bound(c * (4 + m + 4) + m * k * 4, c * m)
    row = timed(lambda: ops.pq_scan_gather(store, ids, store_table),
                lambda: ref.pq_scan_gather_ref(store, ids, store_table),
                shape=[c, m, k, store.shape[0]],
                max_abs_err=float((got - want).abs().max()), bound_ms=bms,
                bound_by=by)
    row["library_ms"], row["library_call_ms"] = time_ms(library)
    row["library_max_abs_err"] = float((lib - want).abs().max())
    out["pq_scan/pre_gather"] = row
    del store, flat_idx

    # approx_probe: kernels_bench's shape (100,000 candidates) and the whole
    # full-size corpus (1M), uint8 buckets, QL=8; bytes: 4 (word) + 1
    # (bucket) + 1 (output) per row
    for tag, n in (("100k", 100_000), ("1M", 1_000_000)):
        blooms = torch.from_numpy(rng.integers(
            0, 2 ** 32, n, dtype=np.int64).astype(np.uint32)
            .view(np.int32)).to(dev)
        buckets = torch.from_numpy(
            rng.integers(0, 256, n).astype(np.uint8)).to(dev)
        or_masks = torch.from_numpy(
            rng.integers(0, 2 ** 16, 8).astype(np.int32)).to(dev)
        params = torch.tensor([0b1010, 8, 50, 200, 2, 1, 1, 0],
                              dtype=torch.int32, device=dev)
        pargs = (blooms, buckets, or_masks, params)
        got = ops.approx_probe(*pargs)
        want = ref.approx_probe_ref(*pargs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"approx_probe ({tag}) differs"
        bms, by = bound(6 * n + 8 * 4 + 8 * 4, 32 * n)
        out[f"approx_probe/{tag}"] = timed(
            lambda: ops.approx_probe(*pargs),
            lambda: ref.approx_probe_ref(*pargs), shape=[n, 8],
            admitted=float(got.float().mean()),
            max_abs_err=float((got.int() - want.int()).abs().max()),
            bound_ms=bms, bound_by=by, library_ms=None)
        if tag == "1M":
            out["approx_probe/1M_cold"] = {
                "shape": [n, 8], "bound_ms": bms, "bound_by": by,
                "ms": time_cold_ms(lambda: ops.approx_probe(*pargs),
                                   scratch)}
    del scratch

    # l2_rerank: kernels_bench's shape (4,096, 128) and one query against
    # the whole full-size corpus (1M, 192); 4·D flops per row
    for tag, (b, d) in (("4096x128", (4096, 128)),
                        ("1Mx192", (1_000_000, 192))):
        vecs = torch.from_numpy(
            rng.normal(0, 1, (b, d)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.normal(0, 1, d).astype(np.float32)).to(dev)
        got = ops.l2_rerank(vecs, q)
        want = ref.l2_rerank_ref(vecs, q)
        torch.cuda.synchronize()
        scale = float(((vecs * vecs).sum(1) + (q * q).sum()).max())
        err = (got - want).abs()
        assert bool((err <= 1e-5 * want.abs() + 1e-5 * scale).all()), \
            f"l2_rerank ({tag}): max abs err {float(err.max())}"

        def library():
            return torch.cdist(vecs, q[None]).square()

        lib = library()[:, 0]
        bms, by = bound(b * d * 4 + d * 4 + b * 4, 4 * b * d)
        row = timed(lambda: ops.l2_rerank(vecs, q),
                    lambda: ref.l2_rerank_ref(vecs, q), shape=[b, d],
                    max_abs_err=float(err.max()), tolerance_scale=scale,
                    bound_ms=bms, bound_by=by)
        row["library_ms"], row["library_call_ms"] = time_ms(library)
        row["library_max_abs_err"] = float((lib - want).abs().max())
        out[f"l2_rerank/{tag}"] = row
    out.update(wide_kernel_rows(dev))
    return {"build_s": build_s, "results": out}


def wide_kernel_rows(dev) -> dict:
    """The kernel rows at M = 64 (768-d vectors at 12 dimensions a
    subspace; a 64 KB table staged past the 48 KB default, by the kernels'
    opt-in), from a generator of their own so the other rows keep their
    inputs: the gathered ``hop_fused`` at (B, C) = (64, 512) with F = 2
    bucket fields and range slots over both (the range route's hop step
    at the LAION cell's widths), and ``pq_scan`` on 1M rows and gathered
    over 50,000 ids of them. Each is bit-identical to its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(64)
    out = {}
    b, c, m, k, f, ql, nr, n = 64, 512, 64, 256, 2, 8, 4, 1_000_000
    nw = (n + 1 + 31) // 32
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    host = [
        codes,
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                         .astype(np.int32)),
        torch.from_numpy(rng.integers(0, 256, (n, f)).astype(np.int32)),
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                                      dtype=np.int64).astype(np.int32)),
        torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)),
        torch.from_numpy((rng.normal(0, 1, (b, m, k)) ** 2)
                         .astype(np.float32)),
        torch.from_numpy(np.stack(
            [rng.integers(0, 2 ** 16, b), rng.integers(0, 3, b),
             rng.integers(0, 3, b), rng.integers(0, 2, b)],
            axis=1).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2 ** 12, (b, ql)).astype(np.int32)),
        # each slot tests field 0, field 1 or nothing
        torch.from_numpy(rng.integers(-1, f, (b, nr)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 128, (b, nr)).astype(np.int32)),
        torch.from_numpy(rng.integers(128, 256, (b, nr)).astype(np.int32)),
    ]
    gargs = [a.to(dev) for a in host]
    key_k, ok_k = ops.hop_fused_gather(*gargs)
    key_p, ok_p = ref.hop_fused_gather_ref(*gargs)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p), "hop_fused/gather/M64: ok differs"
    assert torch.equal(key_k.view(torch.int32), key_p.view(torch.int32)), \
        "hop_fused/gather/M64: key not bit-identical"
    nbytes = (b * c * 4 + b * c * (m + 4 + 4 * f) + b * c * 4
              + b * m * k * 4 + b * (4 + ql + 3 * nr) * 4 + b * c * 5)
    bms, by = bound(nbytes, b * c * m)
    out["hop_fused/gather/M64"] = timed(
        lambda: ops.hop_fused_gather(*gargs),
        lambda: ref.hop_fused_gather_ref(*gargs), shape=[b, c, m, n], fields=f,
        max_abs_err=float((key_k - key_p).abs().max()), bound_ms=bms,
        bound_by=by)

    store, table = gargs[0], gargs[5][0].contiguous()
    del gargs, host
    got = ops.pq_scan(store, table)
    want = ref.pq_scan_ref(store, table)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "pq_scan/scan/M64: not bit-identical"
    bms, by = bound(n * m + m * k * 4 + n * 4, n * m)
    out["pq_scan/scan/M64"] = timed(
        lambda: ops.pq_scan(store, table),
        lambda: ref.pq_scan_ref(store, table), shape=[n, m, k],
        max_abs_err=float((got - want).abs().max()), bound_ms=bms,
        bound_by=by)
    c = 50_000
    ids = torch.from_numpy(rng.integers(0, n, c).astype(np.int32)).to(dev)
    got = ops.pq_scan_gather(store, ids, table)
    want = ref.pq_scan_gather_ref(store, ids, table)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "pq_scan/pre_gather/M64: not bit-identical"
    bms, by = bound(c * (4 + m + 4) + m * k * 4, c * m)
    out["pq_scan/pre_gather/M64"] = timed(
        lambda: ops.pq_scan_gather(store, ids, table),
        lambda: ref.pq_scan_gather_ref(store, ids, table),
        shape=[c, m, k, n], max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by)
    return out


def dsl_request(api, ds, i: int, kind: str, tag_field: str):
    """Query ``i`` of the dataset as a ``SearchRequest`` under a DSL filter
    of the given kind over its labels and value range."""
    labels = ds.query_labels[i]
    lo, hi = float(ds.query_ranges[i, 0]), float(ds.query_ranges[i, 1])
    tag, num = api.Tag(tag_field), api.Num("value")
    filt = {
        "label": tag == labels[0],
        "label_and": api.And.of(*[tag == lab for lab in labels]),
        "range": num.between(lo, hi),
        "hybrid": tag.isin(labels) | num.between(lo, hi),
        "tag_and_num": (tag == labels[0]) & num.between(lo, hi),
    }[kind]
    return api.SearchRequest(query=ds.queries[i], filter=filt)


def _answer(x):
    """``(ids, dists, stats)`` of an engine's answer, or of an ``Index``'s
    ``(results, QueryStats)``."""
    if len(x) == 3:
        return x
    results, stats = x
    return [r.ids for r in results], [r.dists for r in results], stats


def compare_results(label, got, want, exact: bool = False) -> None:
    """Two answers to the same requests, each an ``Index``'s ``(results,
    QueryStats)`` or an engine's ``(ids, dists, stats)``: routes, ids and
    integer counters (fault counters included) equal, distances
    allclose (equal with ``exact``)."""
    import numpy as np
    (ig, dg, sg), (ic, dc, sc) = _answer(got), _answer(want)
    assert sg.mechanism == sc.mechanism, f"{label}: routes differ"
    for f in ("io_pages", "hops", "explored", "dist_comps", "n_valid",
              "fp_explored", "faults", "retries", "degraded"):
        assert np.array_equal(getattr(sg, f), getattr(sc, f)), \
            f"{label}: {f} differs"
    assert len(ig) == len(ic), f"{label}: batch sizes differ"
    for a, b in zip(ig, ic):
        assert np.array_equal(a, b), f"{label}: ids differ"
    for a, b in zip(dg, dc):
        assert (np.array_equal(a, b) if exact else
                np.allclose(a, b, rtol=1e-6, atol=1e-6)), f"{label}: dists"


# ---------------------------------------------------------------------------
# phase 3: the card's path against the CPU's on the test corpus
# ---------------------------------------------------------------------------

def card_vs_cpu_phase(dev) -> dict:
    import numpy as np
    from repro_torch.core import engine as eng
    from repro_torch.data.synth import make_filtered_dataset, make_selectors

    ds = make_filtered_dataset(n=6000, d=32, n_queries=24, n_labels=60,
                               seed=0)
    cfg = eng.IndexConfig(r=24, r_dense=240, l_build=48, pq_m=8)
    t0 = time.perf_counter()
    gpu = eng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                      ds.label_flat, ds.n_labels, ds.values,
                                      cfg, device=dev)
    build_s = time.perf_counter() - t0
    arrays = gpu.arrays()
    again = eng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                        ds.label_flat, ds.n_labels, ds.values,
                                        cfg, device=dev).arrays()
    cpu = eng.FilteredANNEngine.from_arrays(arrays, cfg, device="cpu")
    out = {"build_s": build_s, "workloads": {},
           "rebuild_identical": all(np.array_equal(arrays[k], again[k])
                                    for k in arrays)}
    for wl in ("label", "range", "hybrid"):
        res = []
        for e in (gpu, cpu):
            sels = make_selectors(ds, e, wl)
            res.append(e.search(ds.queries, sels,
                                eng.SearchConfig(policy="speculative")))
        compare_results(wl, res[0], res[1])
        sg = res[0][2]
        mix = {m: sg.mechanism.count(m) for m in sorted(set(sg.mechanism))}
        out["workloads"][wl] = {"mechanisms": mix, "equal": True}

    # the facade: an Index built on the card from metadata dicts, copied to
    # the CPU through its engine's arrays
    from repro_torch import api
    t0 = time.perf_counter()
    gidx = api.Index.build(ds.vectors, ds.metadata(), cfg, device=dev)
    out["index_build_s"] = time.perf_counter() - t0
    cidx = api.Index(eng.FilteredANNEngine.from_arrays(
        gidx.engine.arrays(), cfg, device="cpu"), gidx.vocab, gidx.schema,
        gidx.defaults)
    out["index"] = {}
    for kind in ("label", "label_and", "range", "hybrid"):
        reqs = [dsl_request(api, ds, i, kind, "label")
                for i in range(ds.queries.shape[0])]
        for call in ("search_batch", "approx_scan_batch"):
            got = getattr(gidx, call)(reqs, with_stats=True)
            compare_results(f"Index.{call} {kind}", got,
                            getattr(cidx, call)(reqs, with_stats=True))
            mech = got[1].mechanism
            out["index"][f"{call}/{kind}"] = {
                m: mech.count(m) for m in sorted(set(mech))}
    out["lifecycle"] = small_lifecycle(api, ds, gidx, cidx)
    return out


def small_lifecycle(api, ds, gidx, cidx) -> dict:
    """The index lifecycle on the test corpus, card against CPU: the same
    insert on both (arrays and answers equal), the label / range / hybrid
    requests under the fault plan ``rate=0.1,seed=7`` (answers and fault
    counters equal), then a save on the card and a load on the CPU (the
    loaded index answers as the card's)."""
    import shutil
    import numpy as np
    from repro_torch.core.faults import parse_plan
    from repro_torch.data.synth import make_filtered_dataset

    out = {}
    extra = make_filtered_dataset(n=1500, d=32, n_queries=4, n_labels=60,
                                  seed=3)
    meta = extra.metadata()
    t0 = time.perf_counter()
    ids = gidx.insert(extra.vectors, meta)
    out["insert_s"] = time.perf_counter() - t0
    assert np.array_equal(ids, cidx.insert(extra.vectors, meta)), \
        "insert: ids differ"
    assert ids.tolist() == list(range(6000, 7500)), "insert: ids"
    ga, ca = gidx.engine.arrays(), cidx.engine.arrays()
    for k in ga:
        assert np.array_equal(ga[k], ca[k]), f"insert: {k} differs"
    out["capacity"] = int(gidx.engine.store.vectors.shape[0])
    plan = parse_plan("rate=0.1,seed=7")
    faults = {"faults": 0, "retries": 0, "degraded": 0}
    for kind in ("label", "range", "hybrid"):
        reqs = [dsl_request(api, ds, i, kind, "label")
                for i in range(ds.queries.shape[0])]
        got = gidx.search_batch(reqs, with_stats=True)
        compare_results(f"after insert {kind}", got,
                        cidx.search_batch(reqs, with_stats=True))
        scfgs = [dataclasses.replace(gidx.defaults, fault_plan=plan)] \
            * len(reqs)
        got = gidx.search_batch(reqs, with_stats=True, scfgs=scfgs)
        want = cidx.search_batch(reqs, with_stats=True, scfgs=scfgs)
        compare_results(f"fault plan {kind}", got, want)
        for f in faults:
            faults[f] += int(getattr(got[1], f).sum())
    assert faults["faults"] > 0, "the fault plan drew no fault"
    out["fault_plan"] = {"plan": "rate=0.1,seed=7", **faults}

    path = ROOT / "build" / "smoke_ckpt_small"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        gidx.save(str(path))
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lidx = api.Index.load(str(path), device="cpu")
        out["load_cpu_s"] = time.perf_counter() - t0
        for kind in ("label", "range", "hybrid"):
            reqs = [dsl_request(api, ds, i, kind, "label")
                    for i in range(ds.queries.shape[0])]
            compare_results(f"saved on the card, loaded on the CPU {kind}",
                            gidx.search_batch(reqs, with_stats=True),
                            lidx.search_batch(reqs, with_stats=True))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    out["equal"] = True
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def uncounted():
    """Leave the kernel launches made inside out of the counts."""
    from repro_torch.kernels import ops
    saved = ops.snapshot()
    try:
        yield
    finally:
        ops.restore(saved)


@contextlib.contextmanager
def entry_calls(*names):
    """Count calls of the ``ops`` entries ``names`` while open. Entries of
    one kernel count their launches under one name (``pq_scan`` and
    ``pq_scan_gather`` under ``pq_scan``; ``or_scatter``, ``or_scatter_``
    and ``or_scatter_new`` under ``or_scatter``), and this tells them apart.
    The port calls them through the ``ops`` module, so wrapping the
    module's names sees every call."""
    from repro_torch.kernels import ops
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(ops, name) for name in calls}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in calls:
        setattr(ops, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# the entries phase 4 tells apart
SEARCH_ENTRIES = ("pq_scan", "pq_scan_gather", "or_scatter", "or_scatter_",
                  "or_scatter_new")


def _search_run(e, ds, sels, scfg, label, reachable, repeats: int = 5):
    """One workload through ``engine.search``: a warm-up batch, then
    ``repeats`` timed batches whose kernel launches (and calls of the
    ``pq_scan`` and ``or_scatter`` entries) it reports per batch."""
    import torch
    from repro_torch.kernels import ops

    e.search(ds.queries, sels, scfg)                  # warm-up
    before = ops.snapshot()
    lat = []
    with entry_calls(*SEARCH_ENTRIES) as calls:
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, dists, stats = e.search(ds.queries, sels, scfg)
            lat.append(time.perf_counter() - t0)
    after = ops.snapshot()
    per_batch = {k: (after[k] - before[k]) / repeats for k in before}
    with uncounted():
        row = _check_run(e, ds, sels, scfg, label, ids, stats, lat)
    return {**row, "reachable_from_medoid": reachable,
            "hop_steps_per_batch": stats.trace["hop_steps"],
            "hop_steps_graphed_per_batch": stats.trace["hop_steps_graphed"],
            "launches_per_batch": per_batch,
            "entry_calls_per_batch": {k: v / repeats
                                      for k, v in calls.items()}}


def _check_run(e, ds, sels, scfg, label, ids, stats, lat) -> dict:
    """Exact membership of every returned id, recall against brute force
    on the card, and the run's line."""
    import numpy as np
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.core.selectors import filter_to_device, stack_filters

    cfg = e.config
    s = e.store
    rec = []
    for i, sel in enumerate(sels):
        qf = sel.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
        got = ids[i][ids[i] >= 0]
        if got.size:
            g = torch.from_numpy(got.astype(np.int64)).to(e.device)
            ok = eng.is_member(filter_to_device(stack_filters([qf]),
                                                e.device),
                               s.rec_labels[g][None], s.rec_values[g][None])
            assert bool(ok.all()), f"{label}: query {i} returned invalid ids"
        gt = eng.brute_force_filtered(s.vectors, s.rec_labels, s.rec_values,
                                      qf, ds.queries[i], scfg.k)
        rec.append(eng.recall_at_k(ids[i], gt, scfg.k))
    lat_ms = np.array(lat) * 1e3
    return {
        "run": label, "queries": int(ids.shape[0]),
        "mechanisms": {m: stats.mechanism.count(m)
                       for m in sorted(set(stats.mechanism))},
        "qps": float(ids.shape[0] / np.mean(lat)),
        "p50_batch_ms": float(np.percentile(lat_ms, 50)),
        "p99_batch_ms": float(np.percentile(lat_ms, 99)),
        "recall_at_10": float(np.mean(rec)),
        "mean_hops": float(np.mean(stats.hops)),
        "mean_io_pages": float(np.mean(stats.io_pages)),
    }


def torch_ops(fn) -> int:
    """PyTorch operator calls made by ``fn()`` (``launch.serve``'s count);
    the CUDA kernels, launched through ctypes, come on top."""
    from repro_torch.launch.serve import torch_ops as count
    return count(fn)


def hop_profile(e, ds, cfg, hops: int = 32) -> dict:
    """The hop loop's layer metrics on the label workload in spec_in mode:
    PyTorch operator calls in one hop (:func:`torch_ops`) and the wall time
    per hop over one chunk of ``hops`` hops, synchronised: through
    ``run_hops`` (its hop graph captured by a first chunk beforehand) and
    through the eager loop (``_run_hops_eager``), each from the seeded
    state."""
    import torch
    from repro_torch.core import search
    from repro_torch.core.selectors import stack_filters
    from repro_torch.data.synth import make_selectors

    sels = make_selectors(ds, e, "label")
    qf = stack_filters([s.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
                        for s in sels])
    sp = search.SearchParams(l_search=64, k=10, max_hops=512, l_valid=32,
                             mode="spec_in")
    ctx, st = search.init_search(e.store, e.codes, e.codebook, e.mem, qf,
                                 ds.queries, e.medoid, sp)
    mc = search._mc(e.mem, ctx, sp)
    rec = search._issue(e.store, st, sp)
    # a hop consumes its state (the visited words change in place): the
    # counted hop runs on a copy, the timed chunk on the seeded state
    once = search.HopState(*(t.clone() for t in st))
    n_ops = torch_ops(lambda: search._issue(e.store, search._hop_step(
        e.store, e.codes, e.mem, sp, ctx, mc, once, rec), sp))
    search.run_hops(e.store, e.codes, e.mem, ctx,
                    search.HopState(*(t.clone() for t in st)), hops, sp)

    def ms_per_hop(run) -> float:
        seeded = search.HopState(*(t.clone() for t in st))
        torch.cuda.synchronize(e.device)
        t0 = time.perf_counter()
        run(e.store, e.codes, e.mem, ctx, seeded, hops, sp)
        torch.cuda.synchronize(e.device)
        return (time.perf_counter() - t0) / hops * 1e3

    return {"torch_ops_per_hop": n_ops, "queries": len(sels),
            "ms_per_hop": ms_per_hop(search.run_hops),
            "ms_per_hop_eager": ms_per_hop(search._run_hops_eager)}


def full_phase(dev, n: int):
    """Build and search at full size. The launch counts cover the build and
    the ``engine.search`` runs and nothing else; they are returned under
    ``launches``. Returns ``(out, engine, dataset)``."""
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.core import graph, records
    from repro_torch.data.synth import make_filtered_dataset, make_selectors
    from repro_torch.kernels import ops

    out = {"n": n, "d": 192, "n_labels": 1000}
    t0 = time.perf_counter()
    ds = make_filtered_dataset(n=n, d=192, n_queries=64, n_labels=1000,
                               seed=0)
    out["data_s"] = time.perf_counter() - t0
    cfg = eng.IndexConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    e = eng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                    ds.label_flat, ds.n_labels, ds.values,
                                    cfg, device=dev)
    out["build_s"] = time.perf_counter() - t0
    out["launches_build"] = ops.snapshot()
    assert out["launches_build"]["prune_scan"] > 0, \
        "the build launched no prune_scan"
    out["build_stages_s"] = e.build_times
    out["build_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["host_peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    with uncounted():
        # the record store's first-occurrence mask, timed alone (it ran
        # inside the record-store stage)
        t0 = time.perf_counter()
        records.candidate_first_mask(e.store.neighbors,
                                     e.store.dense_neighbors)
        torch.cuda.synchronize(dev)
        out["cand_first_s"] = time.perf_counter() - t0
        adj = e.store.neighbors.cpu().numpy()
        out["graph"] = graph.graph_stats(adj)
        reachable = graph.reachable_fraction(adj, e.medoid)
        out["reachable_from_medoid"] = reachable
        out["greedy_recall_at_10"] = graph.greedy_recall_at_k(
            ds.vectors, adj, e.medoid, ds.queries, ell=64, device=dev)
        emit({"phase": "full_build", **out})
        emit({"phase": "hop_loop", **hop_profile(e, ds, cfg)})

    runs = []
    for wl, policy in (("label", "speculative"), ("label_and", "speculative"),
                       ("range", "speculative"), ("hybrid", "speculative"),
                       ("range", "post")):
        run = _search_run(e, ds, make_selectors(ds, e, wl),
                          eng.SearchConfig(policy=policy), f"{wl}/{policy}",
                          reachable)
        emit({"phase": "full_search", **run})
        per_batch = run["launches_per_batch"]
        entries = run["entry_calls_per_batch"]
        # the seeding builds the visited set (and the rare-list bitmap)
        # through the fresh entry, which zeroes a table and calls the
        # in-place one; the hop loop calls the in-place entry, a replayed
        # hop step as an eager one; each call is one launch, and nothing
        # calls the slab entry. On the card every hop step is replayed
        graphed = run["hop_steps_graphed_per_batch"]
        assert graphed == (run["hop_steps_per_batch"]
                           if e.device.type == "cuda" else 0), \
            f"{run['run']}: {graphed} of the hop steps were graphed"
        assert entries["or_scatter_new"] > 0, \
            f"{run['run']}: no fresh-table or_scatter call"
        assert entries["or_scatter_"] > entries["or_scatter_new"], \
            f"{run['run']}: no in-place or_scatter call from the hop loop"
        assert entries["or_scatter"] == 0, \
            f"{run['run']}: the slab or_scatter entry was called"
        assert per_batch["or_scatter"] == entries["or_scatter_"], \
            f"{run['run']}: or_scatter launches outside the in-place entry"
        # the pre route's candidate scans go through the gathered entry,
        # one call per pre query, and nothing else launches pq_scan here
        assert entries["pq_scan"] == 0, \
            f"{run['run']}: the slab pq_scan entry was called"
        assert entries["pq_scan_gather"] == run["mechanisms"].get("pre", 0), \
            f"{run['run']}: not one pq_scan_gather call per pre query"
        assert per_batch["pq_scan"] <= entries["pq_scan_gather"]
        if policy == "speculative":
            assert per_batch["hop_fused"] > 0, \
                f"{run['run']}: no hop_fused launch"
        runs.append(run)
    out["launches"] = ops.snapshot()
    out["searches"] = runs
    return out, e, ds


# ---------------------------------------------------------------------------
# phase 5: serving on the full-size engine
# ---------------------------------------------------------------------------

def _check_members(label, e, sels, id_rows) -> int:
    """Exact membership of every id in ``id_rows[i]`` under the compiled
    filter ``sels[i]`` (anything with ``.plan``, as ``Index.compile_filter``
    or ``make_selectors`` returns); returns how many ids were checked."""
    import numpy as np
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.core.selectors import filter_to_device, stack_filters

    cfg, s = e.config, e.store
    n = 0
    for i, (sel, ids) in enumerate(zip(sels, id_rows)):
        got = ids[ids >= 0]
        if not got.size:
            continue
        qf = sel.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
        g = torch.from_numpy(got.astype(np.int64)).to(e.device)
        ok = eng.is_member(filter_to_device(stack_filters([qf]), e.device),
                           s.rec_labels[g][None], s.rec_values[g][None])
        assert bool(ok.all()), f"{label}: request {i} returned an invalid id"
        n += int(got.size)
    return n


def _check_served(label, index, reqs, results) -> int:
    """:func:`_check_members` of an ``Index``'s requests and results."""
    return _check_members(label, index.engine,
                          [index.compile_filter(r.filter) for r in reqs],
                          [res.ids for res in results])


def serve_phase(e, ds, dev):
    """The phase-4 engine behind ``Index`` and ``SearchServer``. The launch
    counts cover the warmup, the calibration, the burst and the scan batch;
    they are returned under ``launches``. Returns ``(out, index)``."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops
    from repro_torch.serve import SearchServer, ServerConfig

    schema = api.Schema(tags=("tag",), nums=("value",))
    vocab = {("tag", i): i for i in range(e.label_store.n_labels)}
    index = api.Index(e, vocab, schema)
    nq = ds.queries.shape[0]
    kinds = ("label", "range", "hybrid")
    reqs = [dsl_request(api, ds, i % nq, kinds[i % 3], "tag")
            for i in range(2 * nq)]
    # a third of the burst carries a 3 s deadline
    burst = [dataclasses.replace(r, deadline_us=3e6) if i % 3 == 0 else r
             for i, r in enumerate(reqs)]
    cfg = ServerConfig(max_queue=64, max_batch=16, max_delay_s=0.002,
                       slo_p99_us=5e6)
    out = {"n": e.n, "requests": len(burst), "server": dataclasses.asdict(cfg)}

    ops.reset_launches()
    srv = SearchServer(index, cfg)
    try:
        t0 = time.perf_counter()
        srv.warmup(reqs[:16], ladder=False)
        out["warmup_s"] = time.perf_counter() - t0
        out["launches_warmup"] = ops.snapshot()
        assert out["launches_warmup"]["pq_scan"] > 0, \
            "the warmup's scan rung launched no pq_scan"
        t0 = time.perf_counter()
        overhead, slope = srv.calibrate_service_model(reqs[:16])
        out["calibrate_s"] = time.perf_counter() - t0
        out["service_model"] = {"overhead_us": overhead,
                                "us_per_cost": slope}

        handles, rejected, shed_admit = [], 0, 0
        t0 = time.perf_counter()
        for r in burst:
            try:
                handles.append((r, srv.submit(r)))
            except api.Overloaded:
                rejected += 1
            except api.DeadlineExceeded:
                shed_admit += 1
        served, expired = [], 0
        for r, h in handles:
            try:
                served.append((r, h, h.result(timeout=900)))
            except api.DeadlineExceeded:
                expired += 1
        out["burst_s"] = time.perf_counter() - t0
        st = srv.stats()
    finally:
        srv.stop()
    assert len(served) + expired + rejected + shed_admit == len(burst)

    torch.cuda.synchronize(dev)
    scan_reqs = reqs[:nq]
    before = ops.snapshot()
    with entry_calls("pq_scan", "pq_scan_gather") as calls:
        t0 = time.perf_counter()
        scan_res, scan_st = index.approx_scan_batch(
            scan_reqs, with_stats=True, with_metadata=False)
        scan_s = time.perf_counter() - t0
    out["launches"] = ops.snapshot()
    out["launches_scan_batch"] = {k: out["launches"][k] - before[k]
                                  for k in before}
    out["pq_entry_calls_scan_batch"] = dict(calls)
    # the scan rung runs the slab entry once per query
    assert calls == {"pq_scan": nq, "pq_scan_gather": 0}, calls
    assert out["launches_scan_batch"]["pq_scan"] == nq

    with uncounted():
        out["burst"] = {
            "completed": st.completed, "admitted": st.admitted,
            "rejected_overload": st.rejected_overload,
            "shed_deadline": st.shed_deadline,
            "shed_at_admission": shed_admit, "expired_in_queue": expired,
            "deadline_misses": st.deadline_misses,
            "degraded_served": st.degraded_served,
            "rungs": dict(collections.Counter(h.rung for _, h, _ in served)),
            "mechanisms": dict(collections.Counter(
                res.stats.mechanism for _, _, res in served)),
            "p50_ms": st.p50_us / 1e3, "p99_ms": st.p99_us / 1e3,
            "verified_ids": _check_served(
                "served burst", index, [r for r, _, _ in served],
                [res for _, _, res in served]),
        }
        rec = []
        k = index.defaults.k
        s, cfg_i = e.store, e.config
        for r, res in zip(scan_reqs, scan_res):
            qf = index.compile_filter(r.filter).plan(
                cfg_i.ql, cfg_i.cap, cfg_i.qr).qfilter
            gt = eng.brute_force_filtered(s.vectors, s.rec_labels,
                                          s.rec_values, qf, r.query, k)
            rec.append(eng.recall_at_k(res.ids, gt, k))
        out["scan"] = {
            "queries": nq, "qps": nq / scan_s, "ms_per_query":
            scan_s / nq * 1e3, "mean_io_pages": float(np.mean(
                scan_st.io_pages)), "recall_at_10": float(np.mean(rec)),
            "recall_at_10_by_kind": {
                kind: float(np.mean(rec[j::3])) for j, kind in
                enumerate(kinds)},
            "rerank": int(scan_st.explored[0]),
            "verified_ids": _check_served("scan rung", index, scan_reqs,
                                          scan_res),
        }
        # how far ADC ranking alone carries the scan rung: the share of each
        # query's exact unfiltered top-k inside its ADC top-rerank
        from repro_torch.core import pq as pq_mod
        hit = []
        for q in ds.queries:
            qt = torch.from_numpy(q).to(dev)
            adc = ops.pq_scan(e.codes, pq_mod.distance_table(e.codebook, qt))
            top = torch.topk(adc, out["scan"]["rerank"], largest=False)
            exact = ((s.vectors - qt) ** 2).sum(1)
            gt_k = torch.topk(exact, k, largest=False).indices
            hit.append(float(torch.isin(gt_k, top.indices).float().mean()))
        out["scan"]["adc_top_rerank_recall_unfiltered"] = float(np.mean(hit))
        out["scan"]["torch_ops_per_query"] = torch_ops(
            lambda: index.approx_scan_batch(scan_reqs[:1],
                                            with_metadata=False))

        # 8 of the scan queries against a CPU copy of the engine
        t0 = time.perf_counter()
        cpu = api.Index(eng.FilteredANNEngine.from_arrays(
            e.arrays(), e.config, device="cpu"), vocab, schema)
        out["cpu_copy_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_res = cpu.approx_scan_batch(scan_reqs[:8], with_stats=True,
                                        with_metadata=False)
        out["cpu_scan_s"] = time.perf_counter() - t0
        first8 = (scan_res[:8], eng.QueryStats(**{
            f.name: getattr(scan_st, f.name)[:8]
            for f in dataclasses.fields(eng.QueryStats)
            if f.name not in ("disk", "trace")}))
        compare_results("approx_scan card vs CPU", first8, cpu_res)
        out["scan"]["card_equals_cpu_on"] = 8
    return out, index


# ---------------------------------------------------------------------------
# phase 6: the ops entry points on the full-size corpus
# ---------------------------------------------------------------------------

PHASE4_KINDS = ("label", "range", "hybrid")    # the single-field filters


def exact_mask(e, sel):
    """Exact membership of every record under one selector, on the card."""
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.core.selectors import filter_to_device, stack_filters

    cfg, s = e.config, e.store
    qf = filter_to_device(stack_filters(
        [sel.plan(cfg.ql, cfg.cap, cfg.qr).qfilter]), e.device)
    parts = [eng.is_member(qf, s.rec_labels[None, a:a + eng.BRUTE_CHUNK],
                           s.rec_values[None, a:a + eng.BRUTE_CHUNK])[0]
             for a in range(0, e.n, eng.BRUTE_CHUNK)]
    return torch.cat(parts)


def probe_params(e, ds, i: int, kind: str):
    """``(or_masks, params)`` of ``ops.approx_probe`` for query ``i`` under
    a single-field filter, from the port's Bloom masks
    (``bloom.label_bits``) and the value field's bucket bounds."""
    import numpy as np
    import torch
    from repro_torch.core import bloom

    labels = np.asarray(ds.query_labels[i])
    labels = labels[labels >= 0]
    lo, hi = float(ds.query_ranges[i, 0]), float(ds.query_ranges[i, 1])
    blo, bhi = e.range_store.field_store(0).bucket_range(lo, hi)
    k_hashes = e.label_store.k_hashes
    or_masks = np.zeros(8, np.uint32)
    if kind == "label":            # its first label, as make_selectors
        prm = [int(bloom.label_bits(labels[0], k_hashes)), 0, 0, 255, 1, 0,
               0, 0]
    elif kind == "range":
        prm = [0, 0, blo, bhi, 0, 1, 0, 0]
    else:                          # any of its labels OR the range
        assert labels.size <= 8, "more query labels than OR masks"
        or_masks[:labels.size] = bloom.label_bits(labels, k_hashes)
        prm = [0, int(labels.size), blo, bhi, 2, 1, 1, 0]
    prm = np.array(prm, np.int64).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(or_masks.view(np.int32)).to(e.device),
            torch.from_numpy(prm).to(e.device))


def ops_phase(e, ds) -> dict:
    """``ops.approx_probe`` and ``ops.l2_rerank`` over the whole full-size
    corpus for each of the 64 phase-4 queries: the probe equals its plain
    version on every query (the AND-label, range and hybrid param blocks)
    and admits every record that exact membership admits (no false
    negatives), and the re-rank's top
    10 equals brute force's unfiltered top 10 up to exact-distance ties
    within the tolerance. The launch counts cover the probe and re-rank
    calls only; they are returned under ``launches``."""
    import numpy as np
    import torch
    from repro_torch.data.synth import make_selectors
    from repro_torch.kernels import ops, ref

    nq = ds.queries.shape[0]
    sels = {kind: make_selectors(ds, e, kind) for kind in PHASE4_KINDS}
    blooms = e.mem.blooms[:e.n]
    buckets = e.mem.bucket_codes[:e.n, 0].contiguous()
    vecs = e.store.vectors[:e.n]
    norms = (vecs * vecs).sum(1)
    ops.reset_launches()
    admitted = {kind: [] for kind in PHASE4_KINDS}
    exact_share = {kind: [] for kind in PHASE4_KINDS}
    top_equal, ties = 0, 0
    t_probe = t_rerank = 0.0
    for i in range(nq):
        kind = PHASE4_KINDS[i % 3]
        or_masks, params = probe_params(e, ds, i, kind)
        torch.cuda.synchronize(e.device)
        t0 = time.perf_counter()
        ok = ops.approx_probe(blooms, buckets, or_masks, params)
        torch.cuda.synchronize(e.device)
        t_probe += time.perf_counter() - t0
        q = torch.from_numpy(ds.queries[i]).to(e.device)
        t0 = time.perf_counter()
        d = ops.l2_rerank(vecs, q)
        top = torch.topk(d, 10, largest=False).indices
        torch.cuda.synchronize(e.device)
        t_rerank += time.perf_counter() - t0
        with uncounted():
            assert torch.equal(ok, ref.approx_probe_ref(
                blooms, buckets, or_masks, params)), \
                f"approx_probe: query {i} ({kind}) differs from the plain " \
                "version"
            exact = exact_mask(e, sels[kind][i])
            assert not bool((exact & ~ok).any()), \
                f"approx_probe: a false negative on query {i} ({kind})"
            admitted[kind].append(float(ok.float().mean()))
            exact_share[kind].append(float(exact.float().mean()))
            # brute force in the other form, sum((v - q)^2)
            ex = ((vecs - q) ** 2).sum(1)
            gt = torch.topk(ex, 10, largest=False)
            tol = 1e-5 * float(norms.max() + (q * q).sum())
            worst = float(ex[top].max())
            assert worst <= float(gt.values[-1]) + tol, \
                f"l2_rerank: query {i} top 10 differs beyond ties"
            same = set(top.tolist()) == set(gt.indices.tolist())
            top_equal += int(same)
            ties += int(not same)
    launches = ops.snapshot()
    assert launches["approx_probe"] == nq and launches["l2_rerank"] == nq
    return {
        "queries": nq, "n": e.n, "launches": launches,
        "probe_admitted_share": {k: float(np.mean(v))
                                 for k, v in admitted.items()},
        "exact_share": {k: float(np.mean(v)) for k, v in exact_share.items()},
        "probe_false_negatives": 0,
        "rerank_top10_equal": top_equal, "rerank_top10_within_ties": ties,
        "probe_call_ms": t_probe / nq * 1e3,
        "rerank_topk_call_ms": t_rerank / nq * 1e3,
    }


# ---------------------------------------------------------------------------
# phase 7: the index lifecycle at full size
# ---------------------------------------------------------------------------

def _label_batch(e, ds, scfg):
    """The phase-4 label workload through ``engine.search``."""
    from repro_torch.data.synth import make_selectors
    sels = make_selectors(ds, e, "label")
    return sels, e.search(ds.queries, sels, scfg)


def lifecycle_phase(index, ds, dev) -> dict:
    """Save the phase-5 ``Index`` under ``build/`` and load it back on the
    card (the label batch answers equal), insert 10,000 records, and run
    the label batch under the fault plan ``rate=0.1,seed=7``: every id a
    query with ``degraded == 0`` returns passes exact membership. The
    checkpoint directory is deleted at the end. Launch counts of the insert
    are returned under ``insert_launches``."""
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as eng
    from repro_torch.core.faults import parse_plan
    from repro_torch.data.synth import make_filtered_dataset
    from repro_torch.kernels import ops

    out = {}
    e = index.engine
    n0 = e.n
    scfg = eng.SearchConfig()
    path = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    out["disk_free_bytes"] = shutil.disk_usage(path.parent).free
    emit({"phase": "lifecycle_start",
          "disk_free_bytes": out["disk_free_bytes"]})
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        index.save(str(path))
        out["save_s"] = time.perf_counter() - t0
        out["saved_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        loaded = api.Index.load(str(path), device=dev)
        torch.cuda.synchronize(dev)
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded2 = api.Index.load(str(path), shards=2, device=dev)
        torch.cuda.synchronize(dev)
        out["load_shards2_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert len(loaded) == n0 and loaded2.engine.n_shards == 2
    _, clean_saved = _label_batch(e, ds, scfg)
    _, clean_loaded = _label_batch(loaded.engine, ds, scfg)
    compare_results("loaded vs saved", clean_saved, clean_loaded)
    out["loaded_answers_equal"] = True
    compare_results("loaded with shards=2 vs loaded", _label_batch(
        loaded2.engine, ds, scfg)[1], clean_loaded, exact=True)
    out["loaded_shards2_answers_equal"] = True
    del loaded, loaded2

    extra = make_filtered_dataset(n=10_000, d=ds.vectors.shape[1],
                                  n_queries=1, n_labels=1000, seed=1)
    meta = [{"tag": m["label"], "value": m["value"]}
            for m in extra.metadata()]
    before = ops.snapshot()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ids = index.insert(extra.vectors, meta)
    torch.cuda.synchronize(dev)
    out["insert_s"] = time.perf_counter() - t0
    after = ops.snapshot()
    out["insert_launches"] = {k: after[k] - before[k] for k in after}
    assert ids.tolist() == list(range(n0, n0 + 10_000)), \
        "inserted ids are not contiguous"
    assert out["insert_launches"]["prune_scan"] > 0, \
        "the insert launched no prune_scan"
    out["inserted"] = int(ids.size)
    out["capacity"] = int(e._builder.capacity)
    with uncounted():
        js = [j for j in range(len(meta)) if meta[j]["tag"]][:64]
        reqs = [api.SearchRequest(
            query=extra.vectors[j],
            filter=api.Tag("tag") == int(meta[j]["tag"][0]), k=10)
            for j in js]
        res = index.search_batch(reqs, with_metadata=False)
        out["self_hit_rate_64"] = float(np.mean(
            [n0 + j in r.ids.tolist() for j, r in zip(js, res)]))

        plan = parse_plan("rate=0.1,seed=7")
        sels, clean = _label_batch(e, ds, scfg)
        t0 = time.perf_counter()
        _, faulted = _label_batch(e, ds, dataclasses.replace(
            scfg, fault_plan=plan))
        out["faulted_batch_s"] = time.perf_counter() - t0
        ids_f, _, st = faulted
        rec = [eng.recall_at_k(ids_f[i], clean[0][i][clean[0][i] >= 0],
                               scfg.k) for i in range(len(sels))]
        whole = [i for i in range(len(sels)) if not st.degraded[i]]
        checked = _check_members(
            "faulted label batch (undegraded queries)", e,
            [sels[i] for i in whole], [ids_f[i] for i in whole])
        out["fault_plan"] = {
            "plan": "rate=0.1,seed=7", "faults": int(st.faults.sum()),
            "retries": int(st.retries.sum()),
            "degraded": int(st.degraded.sum()),
            "queries_degraded": int((st.degraded > 0).sum()),
            "recall_vs_clean": float(np.mean(rec)),
            "verified_ids": checked,
            "mechanisms": dict(collections.Counter(st.mechanism))}
        assert out["fault_plan"]["faults"] > 0, "the plan drew no fault"
    return out


# ---------------------------------------------------------------------------
# phase 8: the disk tier under the full-size engine
# ---------------------------------------------------------------------------

# the disk phase's runs of the phase-4 label batch: (label, policy); the
# routed run sends queries to the pre route and to speculative in-filtering
DISK_RUNS = (("label/post", "post"), ("label/strict_in", "strict_in"),
             ("label/speculative", "speculative"),
             ("label/strict_pre", "strict_pre"))
DISK_ENTRIES = SEARCH_ENTRIES + ("hop_fused_gather", "hop_fused")
# the disk runs whose hop steps run eagerly on the disk tier: strict_in's
# attribute probe is a second host read inside the hop step, and a fault
# plan keeps every hop eager; the others replay every hop step
DISK_EAGER = ("label/strict_in", "label/faults rate=0.1,seed=7")


def _counted(fn):
    """``fn()`` with the kernel launches and ``ops`` entry calls it made:
    ``(result, launches, entry_calls)``."""
    from repro_torch.kernels import ops
    before = ops.snapshot()
    with entry_calls(*DISK_ENTRIES) as calls:
        res = fn()
    after = ops.snapshot()
    return res, {k: after[k] - before[k] for k in after}, dict(calls)


@contextlib.contextmanager
def capture_calls(calls: dict):
    """The ``ops`` entry calls counted in ``calls`` (``entry_calls``'s)
    that hop-graph captures made while open: their warm-up hops."""
    from repro_torch.core import search
    made = collections.Counter()
    capture = search._HopGraph.capture

    def counted(self, *args, **kwargs):
        before = dict(calls)
        try:
            return capture(self, *args, **kwargs)
        finally:
            made.update({k: calls[k] - before[k] for k in calls})

    search._HopGraph.capture = counted
    try:
        yield made
    finally:
        search._HopGraph.capture = capture


def _meminfo() -> dict:
    """``/proc/meminfo``'s fields in bytes (the host's page cache)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            v = v.split()
            out[k] = int(v[0]) * (1024 if v[1:] == ["kB"] else 1)
    return out


def _disk_line(ds, stats, n_queries: int, seconds: float) -> dict:
    """One disk run's numbers: pages/query modeled (``io_pages``) and
    measured (pages read from the slab file, read-ahead included), the page
    cache's hit rate, the attribute probes and per-page read latency."""
    import numpy as np
    snap = ds.snapshot()
    return {
        "pages_per_query_modeled": float(np.mean(stats.io_pages)),
        "pages_per_query_measured": snap["pages_read"] / n_queries,
        "records_fetched": snap["records_fetched"],
        "hit_rate": snap["hit_rate"], "hits": snap["hits"],
        "misses": snap["misses"], "evictions": snap["evictions"],
        "readahead_pages": snap["readahead_pages"],
        "readahead_hits": snap["readahead_hits"],
        "attr_probes": snap["attr_probes"],
        "gated_skips": snap["gated_skips"],
        "attr_reads": snap["attr_reads"],
        "gated_share": (snap["gated_skips"] / snap["attr_probes"]
                        if snap["attr_probes"] else 0.0),
        "faults": snap["faults"], "retries": snap["retries"],
        "degraded": snap["degraded"],
        "p50_page_us": snap["p50_page_us"],
        "p95_page_us": snap["p95_page_us"], "preads": snap["preads"],
        # the store keeps its first 4,096 timing samples (serial and batch
        # together): the percentiles cover those, not every pread
        "page_us_samples": snap["n_samples"],
        "seconds": seconds, "qps": n_queries / seconds,
        "mechanisms": dict(collections.Counter(stats.mechanism)),
    }


def disk_phase(index, ds, dev) -> dict:
    """Spill the full-size engine (after phase 7's inserts) to slab files
    under ``build/`` with ``to_disk`` and rerun, on the disk backend, what
    ran on the device backend just before the spill: the phase-4 label
    batch under the post, strict_in, speculative (pre and spec_in routes)
    and strict_pre policies, the phase-7 label batch under the fault plan
    ``rate=0.1,seed=7``, and 8 scan-rung requests through
    ``approx_scan_batch``. Every answer must equal the device backend's
    (ids, distances, routes and integer counters, the ladder's included),
    and every run must launch the same kernels through the same ``ops``
    entries as on the device backend; a disk run that captured hop graphs
    is made again before it is compared (a capture's warm-up hop launches
    kernels of its own). On disk every hop step is replayed, but those of
    the ``DISK_EAGER`` runs. The speculative run is repeated on a fresh
    store (which captures its graphs anew) after the slab file is written
    back and dropped from the OS page cache (``fsync``, then
    ``posix_fadvise(DONTNEED)``). Launch counts of the disk runs are
    returned under ``launches``, entry calls under ``entry_calls``; the
    slab directory is deleted at the end."""
    import os
    import shutil
    import torch
    from repro_torch import api
    from repro_torch.core import engine as eng
    from repro_torch.core.faults import parse_plan
    from repro_torch.data.synth import make_selectors
    from repro_torch.kernels import ops
    from repro_torch.storage import DiskRecordStore

    e = index.engine
    nq = ds.queries.shape[0]
    sels = make_selectors(ds, e, "label")
    plan = parse_plan("rate=0.1,seed=7")
    scan_reqs = [dsl_request(api, ds, i, ("label", "range", "hybrid")[i % 3],
                             "tag") for i in range(8)]
    runs = {label: (lambda p=policy: e.search(
        ds.queries, sels, eng.SearchConfig(policy=p)))
        for label, policy in DISK_RUNS}
    runs["label/faults rate=0.1,seed=7"] = lambda: e.search(
        ds.queries, sels, eng.SearchConfig(fault_plan=plan))
    runs["scan/8"] = lambda: _answer(index.approx_scan_batch(
        scan_reqs, with_stats=True, with_metadata=False))

    # the device backend's answers, launches and entry calls: each run made
    # once first, so that its hop graphs are captured (a capture's warm-up
    # hop launches kernels of its own), and held to the eager loop's
    want = {}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res, launches, calls = _counted(fn)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        with eager_hops():
            _, eager_launches, eager_calls = _counted(fn)
        assert (eager_launches, eager_calls) == (launches, calls), \
            f"{label}: hop graph launches {launches}, calls {calls} != " \
            f"eager {eager_launches}, {eager_calls}"
        want[label] = (res, launches, calls, secs)

    path = ROOT / "build" / "smoke_slabs"
    shutil.rmtree(path, ignore_errors=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {"n": e.n, "disk_free_bytes": shutil.disk_usage(path.parent).free}
    emit({"phase": "disk_start", **out})
    try:
        t0 = time.perf_counter()
        e.to_disk(str(path))
        out["spill_s"] = time.perf_counter() - t0
        store = e.disk_store
        out["file_bytes"] = store.file_bytes
        out["stub_bytes"] = store.stub_bytes()
        out["slab_pages"] = store.layout.slab_pages
        out["pages_std"], out["pages_dense"] = store.pages_std, \
            store.pages_dense
        assert store.n == e.n and e.store.n == 1
        emit({"phase": "disk_spill", **out})

        ops.reset_launches()
        totals = collections.Counter()
        lines = {}
        for label, fn in runs.items():
            for _ in range(2):
                store.reset_counters()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                res, launches, calls = _counted(fn)
                torch.cuda.synchronize(dev)
                secs = time.perf_counter() - t0
                captures = res[2].trace["graph_captures"]
                if not captures:
                    break
            assert not captures, f"{label}: captured again when repeated"
            steps = res[2].trace["hop_steps"]
            graphed = res[2].trace["hop_steps_graphed"]
            eager = label in DISK_EAGER or torch.device(dev).type != "cuda"
            assert graphed == (0 if eager else steps), \
                f"{label}: {graphed} of {steps} hop steps graphed on disk"
            w_res, w_launches, w_calls, w_secs = want[label]
            compare_results(f"disk vs device: {label}", res, w_res,
                            exact=True)
            assert launches == w_launches, \
                f"{label}: launches {launches} != device {w_launches}"
            assert calls == w_calls, \
                f"{label}: entry calls {calls} != device {w_calls}"
            assert res[2].disk is not None
            totals.update(calls)
            n = len(res[0])
            lines[label] = {**_disk_line(store, res[2], n, secs),
                            "device_seconds": w_secs,
                            "hop_steps": steps, "hop_steps_graphed": graphed,
                            "launches": launches, "entry_calls": calls}
            emit({"phase": "disk_run", "run": label, "pass": "after_write",
                  **lines[label]})
        out["launches"] = ops.snapshot()

        spec = lines["label/speculative"]["mechanisms"]
        assert spec.get("pre", 0) > 0 and spec.get("in", 0) > 0, \
            f"the routed run took no pre or no spec_in route: {spec}"
        assert lines["label/strict_in"]["gated_skips"] > 0, \
            "strict_in skipped no attribute page"
        faults = lines["label/faults rate=0.1,seed=7"]
        assert faults["faults"] > 0, "the plan drew no fault on disk"
        assert lines["scan/8"]["records_fetched"] > 0

        # a cold pass: the file written back and dropped from the OS page
        # cache (DONTNEED leaves dirty pages, hence the fsync first), a
        # fresh store (empty page cache)
        fd = os.open(str(path / "records.slab"), os.O_RDONLY)
        try:
            before = _meminfo()
            t0 = time.perf_counter()
            os.fsync(fd)
            fsync_s = time.perf_counter() - t0
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            after = _meminfo()
        finally:
            os.close(fd)
        out["evict"] = {
            "fsync_s": fsync_s, "file_bytes": store.file_bytes,
            "dirty_bytes_before": before["Dirty"],
            "cached_bytes_before": before["Cached"],
            "cached_bytes_after": after["Cached"],
            "cached_bytes_dropped": before["Cached"] - after["Cached"]}
        emit({"phase": "disk_evict", **out["evict"]})
        e.attach_disk_store(DiskRecordStore(str(path)))
        label = "label/speculative"
        t0 = time.perf_counter()
        # the fresh store's graphs are captured in this run: the entry
        # calls of the captures' warm-up hops are told apart
        with entry_calls(*DISK_ENTRIES) as calls, \
                capture_calls(calls) as warm:
            res = runs[label]()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        compare_results(f"disk vs device: {label} (cold)", res,
                        want[label][0], exact=True)
        assert collections.Counter(calls) - warm == collections.Counter(
            want[label][2]), (calls, warm)
        cold = _disk_line(e.disk_store, res[2], len(res[0]), secs)
        emit({"phase": "disk_run", "run": label, "pass": "after_fadvise",
              **cold})
        out["io_model"] = dataclasses.asdict(e.calibrate_io())
    finally:
        if e.disk_store is not None:
            e.disk_store.close()
        shutil.rmtree(path, ignore_errors=True)
    out["runs"] = lines
    out["cold"] = cold
    out["entry_calls"] = dict(totals)
    out["equal"] = True
    return out


# ---------------------------------------------------------------------------
# phase 9: the oracles on the full-size engine
# ---------------------------------------------------------------------------

ORACLE_MODES = ("post", "spec_in", "strict_in")
# the batch's search parameters in every phase-9 run (W = 1, as the engine)
ORACLE_PARAMS = dict(l_search=64, k=10, max_hops=256, l_valid=32)
# BENCH_build.json's corpus and parameters (benchmarks/bench_build.py)
BUILD_BENCH = dict(n=12_000, d=48, n_queries=32, r=24, ell=48, alpha=1.2)


def _oracle_batch(e, ds, sels, mode: str):
    """The arguments of every search driver for one selector batch in
    ``mode``, and its strict_in entry seeds (None in the other modes)."""
    import numpy as np
    from repro_torch.core import engine as eng
    from repro_torch.core import search
    from repro_torch.core.selectors import stack_filters

    cfg = e.config
    qf = stack_filters([s.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
                        for s in sels])
    ents = None
    if mode == "strict_in":
        ents = np.full((len(sels), 4), -1, np.int32)
        for j, s in enumerate(sels):
            seeds, _ = eng._strict_seed_ids(s, e.medoid, 4)
            ents[j, :seeds.size] = seeds
    sp = search.SearchParams(mode=mode, **ORACLE_PARAMS)
    return (e.store, e.codes, e.codebook, e.mem, qf, ds.queries, e.medoid,
            sp), ents


def _synced(fn, dev):
    """``(fn(), seconds)``, the host clock around a synchronised call."""
    import torch
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def _recall10(e, ds, sels, ids) -> float:
    """Mean recall@10 of ``ids`` (B, 10) against brute force on the card."""
    import numpy as np
    from repro_torch.core import engine as eng
    cfg, s = e.config, e.store
    ids = ids.cpu().numpy()
    rec = []
    for i, sel in enumerate(sels):
        qf = sel.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
        gt = eng.brute_force_filtered(s.vectors, s.rec_labels, s.rec_values,
                                      qf, ds.queries[i], 10)
        rec.append(eng.recall_at_k(ids[i], gt, 10))
    return float(np.mean(rec))


def _same_fields(label, got, want) -> None:
    """Every SearchResult field equal, floats bit for bit."""
    import torch
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{label}: {f} differs"


def _hop_ops(e, args, ents) -> tuple[int, int]:
    """PyTorch operator calls in one hop (:func:`torch_ops`) of the
    oracle (its loop condition and body) and of the fused hop step (the
    step and the next frontier's fetch), both from the seeded state."""
    from repro_torch.core import search
    store, codes, codebook, mem, qf, queries, entry, sp = args
    ctx, st = search._naive_init(codes, codebook, mem, qf, queries, entry,
                                 sp, ents, None, False)
    oracle = torch_ops(lambda: search._naive_hop(
        store, codes, mem, sp, ctx, st, search._naive_running(st, sp), None,
        search.local_fetch, False))
    fctx, fst = search.init_search(*args, entries=ents)
    mc = search._mc(mem, fctx, sp)
    rec = search._issue(store, fst, sp)
    fused = torch_ops(lambda: search._issue(store, search._hop_step(
        store, codes, mem, sp, fctx, mc, fst, rec), sp))
    return oracle, fused


def oracle_phase(e, ds, dev, reachable: float) -> dict:
    """Phase 9 on the full-size engine (N = 1,000,000, device backend,
    before phase 7's inserts: the visited set is exact below 2**20 ids).
    Runs, each printing one line: ``oracle_parity`` (``filtered_search``
    against ``filtered_search_ref`` in post, spec_in and strict_in on the
    label batch and a 30% range batch: io_pages, explored, hops and
    n_valid equal per query, mean recall@10 within 0.01), ``distance_fn``
    (the spec_in label batch with ``distance_fn=ops.pq_scan`` through the
    compacting driver and through the oracle, each equal on every field to
    its default-distance run, ``pq_scan`` launched), ``legacy``
    (``filtered_search_legacy`` against the compacting driver under post
    and spec_in: ms per batch, recall@10, every id passes exact
    membership), ``active_trace`` (``collect_trace=True``, equal to the
    untraced run) and ``reference_build`` (both builders on
    BENCH_build.json's corpus: seconds, greedy recall@10, batched ≥
    reference − 0.01). Launch counts of the phase are returned under
    ``launches``."""
    import numpy as np
    import torch
    from repro_torch.core import graph, search
    from repro_torch.data.synth import (make_filtered_dataset,
                                        make_selectors,
                                        make_sliding_range_selectors)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import visited_spec

    n_ids = e.codes.shape[0]
    assert visited_spec(n_ids)[0] >= n_ids, \
        f"the visited set hashes at {n_ids} ids: the counters may differ"
    nq = ds.queries.shape[0]
    batches = {"label": make_selectors(ds, e, "label"),
               "range30": make_sliding_range_selectors(e, 0.30, nq)}
    out = {"n": int(n_ids), "parity": [], "reachable_from_medoid": reachable}
    ops.reset_launches()
    oracle_runs = {}
    for bname, sels in batches.items():
        for mode in ORACLE_MODES:
            args, ents = _oracle_batch(e, ds, sels, mode)
            fused, fused_s = _synced(
                lambda: search.filtered_search(*args, entries=ents), dev)
            ref, ref_s = _synced(
                lambda: search.filtered_search_ref(*args, entries=ents), dev)
            label = f"oracle_parity {bname}/{mode}"
            for f in ("io_pages", "explored", "hops", "n_valid"):
                bad = torch.nonzero(getattr(fused, f) != getattr(ref, f))
                assert bad.numel() == 0, \
                    f"{label}: {f} differs first at query {int(bad[0, 0])}"
            assert int(ref.faults.sum() + ref.retries.sum()
                       + ref.degraded.sum()) == 0
            with uncounted():
                r_f = _recall10(e, ds, sels, fused.ids)
                r_r = _recall10(e, ds, sels, ref.ids)
                oracle_ops, fused_ops = _hop_ops(e, args, ents)
            assert abs(r_f - r_r) <= 0.01, f"{label}: recall {r_f} vs {r_r}"
            line = {"run": f"{bname}/{mode}", "queries": nq,
                    "fused_s": fused_s, "oracle_s": ref_s,
                    "oracle_over_fused": ref_s / fused_s,
                    "oracle_torch_ops_per_hop": oracle_ops,
                    "fused_torch_ops_per_hop": fused_ops,
                    "mean_hops": float(fused.hops.float().mean()),
                    "max_hops": int(fused.hops.max()),
                    "mean_io_pages": float(fused.io_pages.float().mean()),
                    "recall_at_10_fused": r_f, "recall_at_10_oracle": r_r,
                    "counters_equal": True,
                    "reachable_from_medoid": reachable}
            emit({"phase": "oracle_parity", **line})
            out["parity"].append(line)
            oracle_runs[(bname, mode)] = ref

    # distance_fn: the spec_in label batch through pq_scan
    sels = batches["label"]
    args, _ = _oracle_batch(e, ds, sels, "spec_in")
    default, default_s = _synced(
        lambda: search.filtered_search_pipelined(*args), dev)
    before = ops.snapshot()
    with entry_calls("or_scatter_", "or_scatter_new", "pq_scan",
                     "hop_fused_gather") as calls:
        scanned, scan_s = _synced(lambda: search.filtered_search_pipelined(
            *args, distance_fn=ops.pq_scan), dev)
    after = ops.snapshot()
    _same_fields("distance_fn=pq_scan vs default", scanned, default)
    hop_steps = calls["or_scatter_"] - calls["or_scatter_new"]
    pq_launches = after["pq_scan"] - before["pq_scan"]
    assert pq_launches > 0 and calls["hop_fused_gather"] == 0
    before = ops.snapshot()
    ref_scan, ref_scan_s = _synced(lambda: search.filtered_search_ref(
        *args, distance_fn=ops.pq_scan), dev)
    ref_pq_launches = ops.snapshot()["pq_scan"] - before["pq_scan"]
    _same_fields("oracle distance_fn=pq_scan vs oracle default", ref_scan,
                 oracle_runs[("label", "spec_in")])
    out["distance_fn"] = {
        "run": "label/spec_in", "default_s": default_s, "pq_scan_s": scan_s,
        "pq_scan_launches": pq_launches, "hop_steps": hop_steps,
        "pq_scan_launches_per_hop_step": pq_launches / max(hop_steps, 1),
        "mean_hops": float(scanned.hops.float().mean()),
        "max_hops": int(scanned.hops.max()),
        "oracle_pq_scan_s": ref_scan_s,
        "oracle_pq_scan_launches": ref_pq_launches, "equal": True}
    emit({"phase": "distance_fn", **out["distance_fn"]})

    # legacy: the pre-fused baseline against the compacting driver
    out["legacy"] = []
    for mode in ("post", "spec_in"):
        args, _ = _oracle_batch(e, ds, sels, mode)
        row = {"run": f"label/{mode}"}
        for name, fn in (("legacy", search.filtered_search_legacy),
                         ("pipelined", search.filtered_search_pipelined)):
            times = []
            for _ in range(3):
                res, secs = _synced(lambda: fn(*args), dev)
                times.append(secs)
            with uncounted():
                row[f"{name}_verified_ids"] = _check_members(
                    f"legacy phase {name}/{mode}", e, sels,
                    list(res.ids.cpu().numpy()))
                row[f"{name}_recall_at_10"] = _recall10(e, ds, sels,
                                                        res.ids)
            row[f"{name}_ms"] = float(np.median(times)) * 1e3
            row[f"{name}_mean_hops"] = float(res.hops.float().mean())
        row["legacy_over_pipelined"] = row["legacy_ms"] / row["pipelined_ms"]
        emit({"phase": "legacy", **row})
        out["legacy"].append(row)

    # the compaction trace of the spec_in label batch
    args, _ = _oracle_batch(e, ds, sels, "spec_in")
    traced, trace = search.filtered_search_pipelined(*args,
                                                     collect_trace=True)
    _same_fields("collect_trace vs untraced", traced, default)
    out["active_trace"] = trace
    emit({"phase": "active_trace", "run": "label/spec_in", "trace": trace,
          "equal": True})

    # both builders on BENCH_build.json's corpus
    b = BUILD_BENCH
    bds = make_filtered_dataset(n=b["n"], d=b["d"], n_queries=b["n_queries"],
                                seed=0)
    built = {}
    for name, fn in (("batched", graph.build_vamana_batched),
                     ("reference", graph.build_vamana)):
        (adj, med), secs = _synced(lambda: fn(
            bds.vectors, b["r"], b["ell"], b["alpha"], seed=0, device=dev),
            dev)
        with uncounted():
            rec = graph.greedy_recall_at_k(bds.vectors, adj, med,
                                           bds.queries, ell=64, device=dev)
        built[name] = {"seconds": secs, "recall_at_10": rec,
                       "medoid": med, **graph.graph_stats(adj)}
    assert built["batched"]["medoid"] == built["reference"]["medoid"]
    assert built["batched"]["recall_at_10"] >= \
        built["reference"]["recall_at_10"] - 0.01, built
    out["reference_build"] = {
        "corpus": {k: b[k] for k in ("n", "d", "r", "ell", "alpha")},
        **built,
        "reference_over_batched": built["reference"]["seconds"]
        / built["batched"]["seconds"]}
    emit({"phase": "reference_build", **out["reference_build"]})
    out["launches"] = ops.snapshot()
    return out


# ---------------------------------------------------------------------------
# phase 10: sharded execution on the full-size engine
# ---------------------------------------------------------------------------

# the phase-4 batches (workload, policy), each run at S = 2; at S = 4 the
# label batch under the speculative policy (its pre and spec_in routes) and
# under strict_in
SHARD_RUNS = ((2, "label", "speculative"), (2, "label_and", "speculative"),
              (2, "range", "speculative"), (2, "hybrid", "speculative"),
              (2, "range", "post"), (4, "label", "speculative"),
              (4, "label", "strict_in"))
EXACT_SHARD_N = 100_000         # rows of the exact-navigation build
SHARD_BUILD_MIN_N = 250_000     # the PQ-navigated build's deepest cut
# seconds per corpus row of the PQ-navigated build, seconds of the rest of
# phase 10 after it (the exact build, the diagnostics) and seconds per
# corpus row of phases 7 and 8: 262 per 1M, 50 and 170 per 1M in the
# slowest run so far on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6,
# run 19c)
SHARD_BUILD_S_PER_ROW = 270.0 / 1_000_000
SHARD_TAIL_S = 60.0
AFTER_SHARD_S_PER_ROW = 180.0 / 1_000_000
SMOKE_BUDGET_S = 1000.0         # the whole smoke's target


@contextlib.contextmanager
def eager_hops():
    """Run ``search.run_hops`` as the eager loop while open (the pipelined
    driver calls it through the module): no hop step is replayed."""
    from repro_torch.core import search
    graphed = search.run_hops
    search.run_hops = search._run_hops_eager
    try:
        yield
    finally:
        search.run_hops = graphed


@contextlib.contextmanager
def hop_steps():
    """Count ``search._hop_step`` calls while open: the unsharded hop loop
    and every shard of the sharded runner call it through the module."""
    from repro_torch.core import search
    n = [0]
    step = search._hop_step

    def counted(*args, **kwargs):
        n[0] += 1
        return step(*args, **kwargs)

    search._hop_step = counted
    try:
        yield n
    finally:
        search._hop_step = step


def _shard_run(e, ds, dev, shards, wl, policy) -> dict:
    """One phase-4 batch unsharded (warm from phase 4) and through
    ``engine.shard(shards)``: the sharded answers equal the unsharded
    run's per query, distances bit for bit. Reports seconds per batch, hop
    steps and kernel launches of both."""
    from repro_torch.core import engine as eng
    from repro_torch.data.synth import make_selectors
    from repro_torch.kernels import ops

    sels = make_selectors(ds, e, wl)
    scfg = eng.SearchConfig(policy=policy)
    row = {"run": f"{wl}/{policy}", "shards": shards}
    answers = {}
    for s in (0, shards):
        e.shard(s)
        before = ops.snapshot()
        with hop_steps() as steps:
            res, secs = _synced(lambda: e.search(ds.queries, sels, scfg), dev)
        after = ops.snapshot()
        tag = "sharded" if s else "unsharded"
        answers[tag] = res
        # a replayed hop step calls no _hop_step: the tally counts those
        graphed = res[2].trace["hop_steps_graphed"]
        row[tag] = {"s": secs, "hop_steps": steps[0] + graphed,
                    "launches": {k: after[k] - before[k] for k in after}}
    e.shard(0)
    compare_results(f"shard {row['run']} S={shards}", answers["sharded"],
                    answers["unsharded"], exact=True)
    stats = answers["unsharded"][2]
    row["mechanisms"] = dict(collections.Counter(stats.mechanism))
    row["mean_hops"] = float(stats.hops.mean())
    row["sharded_over_unsharded_s"] = row["sharded"]["s"] / \
        row["unsharded"]["s"]
    for tag in ("unsharded", "sharded"):
        r = row[tag]
        r["launches_per_hop_step"] = {
            k: r["launches"][k] / max(1, r["hop_steps"])
            for k in ("hop_fused", "or_scatter")}
    return row


def _shard_hop_ops(e, ds, shards) -> dict:
    """PyTorch operator calls (:func:`torch_ops`) of one hop of the spec_in
    label batch (64 queries): the eager loop (``_run_hops_eager``)
    unsharded, ``runner.run`` at S shards; each from the seeded state, the
    next frontier's fetch included."""
    from repro_torch.core import distributed, search
    from repro_torch.core.selectors import stack_filters
    from repro_torch.data.synth import make_selectors

    cfg = e.config
    qf = stack_filters([s.plan(cfg.ql, cfg.cap, cfg.qr).qfilter
                        for s in make_selectors(ds, e, "label")])
    sp = search.SearchParams(l_search=64, k=10, max_hops=512, l_valid=32,
                             mode="spec_in")
    ctx, st = search.init_search(e.store, e.codes, e.codebook, e.mem, qf,
                                 ds.queries, e.medoid, sp)
    runner = distributed.ShardedSearchRunner(
        distributed.local_plan(shards, e.device), e.store, e.codes,
        e.codebook, e.mem)

    def fresh():
        return search.HopState(*(t.clone() for t in st))

    return {"unsharded": torch_ops(lambda: search._run_hops_eager(
                e.store, e.codes, e.mem, ctx, fresh(), 1, sp)),
            "sharded": torch_ops(lambda: runner.run(ctx, fresh(), 1, sp))}


def _subset(ds, n: int):
    """The first ``n`` records of the phase-4 dataset: (vectors,
    label_offsets, label_flat, values)."""
    off = ds.label_offsets[:n + 1]
    return (ds.vectors[:n], off, ds.label_flat[:int(off[-1])],
            ds.values[:n])


def shard_phase(e, ds, dev, full: dict, t_start: float) -> dict:
    """Phase 10 on the full-size engine (device backend, before phase 7's
    inserts). ``shard_run`` lines: every phase-4 batch through
    ``engine.shard(2)``, and the label batch under the speculative and
    strict_in policies through ``engine.shard(4)``, each equal per query to
    the unsharded run made beside it. ``shard_hop`` (PyTorch calls a hop
    and the device memory each runner added), ``shard_build`` (the
    PQ-navigated ``FilteredANNEngine.build(shards=2)`` on the phase-4 corpus
    — halved, not below SHARD_BUILD_MIN_N rows, while the smoke would pass
    SMOKE_BUDGET_S — against phase 4's build) and ``shard_exact_build``
    (``build_vamana_sharded`` at S = 4 with exact navigation on the first
    EXACT_SHARD_N rows, element for element ``build_vamana_batched`` on
    them). Launch counts of the phase are returned under ``launches``."""
    import numpy as np
    import torch
    from repro_torch.core import distributed, graph
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops

    out = {"runs": []}
    ops.reset_launches()
    with entry_calls("hop_fused_gather", "hop_fused", "or_scatter_",
                     "or_scatter_new", "or_scatter") as calls:
        for shards, wl, policy in SHARD_RUNS:
            row = _shard_run(e, ds, dev, shards, wl, policy)
            emit({"phase": "shard_run", **row})
            out["runs"].append(row)
    out["entry_calls"] = dict(calls)
    assert calls["hop_fused_gather"] > 0 and calls["or_scatter_"] > 0, \
        "the sharded runs launched no hop_fused_gather / or_scatter_"
    assert calls["hop_fused"] == 0 and calls["or_scatter"] == 0, \
        "a slab entry was called in phase 10"

    with uncounted():
        hop = {"torch_ops_per_hop": {}, "runner_added_bytes": {}}
        for shards in (2, 4):
            hop["torch_ops_per_hop"][shards] = _shard_hop_ops(e, ds, shards)
            torch.cuda.synchronize(dev)
            m0 = torch.cuda.memory_allocated(dev)
            e.shard(shards)
            torch.cuda.synchronize(dev)
            hop["runner_added_bytes"][shards] = \
                torch.cuda.memory_allocated(dev) - m0
            e.shard(0)
        emit({"phase": "shard_hop", **hop})
        out["hop"] = hop

    # the PQ-navigated sharded build on the phase-4 corpus, halved (not
    # below SHARD_BUILD_MIN_N rows) while the smoke would run past its budget
    n = full["n"]
    elapsed = time.perf_counter() - t_start
    rest = elapsed + SHARD_TAIL_S + AFTER_SHARD_S_PER_ROW * full["n"]
    while n // 2 >= SHARD_BUILD_MIN_N and \
            rest + SHARD_BUILD_S_PER_ROW * n > SMOKE_BUDGET_S:
        n //= 2
    cut = None if n == full["n"] else (
        f"sharded build N {full['n']} -> {n}: {elapsed:.0f} s elapsed, "
        f"budget {SMOKE_BUDGET_S:.0f} s")
    vectors, off, flat, values = _subset(ds, n)
    cfg = eng.IndexConfig()
    before = ops.snapshot()
    e2, secs = _synced(lambda: eng.FilteredANNEngine.build(
        vectors, off, flat, ds.n_labels, values, cfg, shards=2, device=dev),
        dev)
    after = ops.snapshot()
    build = {"n": n, "cut": cut, "shards": e2.n_shards, "build_s": secs,
             "build_stages_s": e2.build_times,
             "launches": {k: after[k] - before[k] for k in after},
             "phase4_build_s": full["build_s"],
             "phase4_build_stages_s": full["build_stages_s"]}
    assert e2.n_shards == 2, "the sharded build did not come back sharded"
    assert build["launches"]["prune_scan"] > 0, \
        "the sharded build launched no prune_scan"
    with uncounted():
        adj = e2.store.neighbors.cpu().numpy()
        build["graph"] = graph.graph_stats(adj)
        build["reachable_from_medoid"] = graph.reachable_fraction(adj,
                                                                  e2.medoid)
        build["greedy_recall_at_10"] = graph.greedy_recall_at_k(
            vectors, adj, e2.medoid, ds.queries, ell=64, device=dev)
    build["phase4_reachable_from_medoid"] = full["reachable_from_medoid"]
    build["phase4_greedy_recall_at_10"] = full["greedy_recall_at_10"]
    del e2, adj
    torch.cuda.empty_cache()
    emit({"phase": "shard_build", **build})
    out["build"] = build

    # exact navigation at S = 4 against the batched builder, on the card
    n_ex = min(EXACT_SHARD_N, full["n"])
    x = ds.vectors[:n_ex]
    st, times = {}, {}
    (adj_s, med_s), sharded_s = _synced(
        lambda: distributed.build_vamana_sharded(
            x, distributed.local_plan(4, dev), cfg.r, cfg.l_build,
            cfg.alpha, seed=cfg.seed, stage_times=st), dev)
    (adj_b, med_b), batched_s = _synced(lambda: graph.build_vamana_batched(
        x, cfg.r, cfg.l_build, cfg.alpha, seed=cfg.seed, device=dev,
        timings=times), dev)
    exact = {"n": n_ex, "shards": 4, "sharded_s": sharded_s,
             "stage_times_s": st, "batched_s": batched_s,
             "batched_passes_s": times, "medoid_equal": med_s == med_b,
             "rows_differing": int((adj_s != adj_b).any(1).sum())}
    emit({"phase": "shard_exact_build", **exact})
    assert exact["medoid_equal"] and exact["rows_differing"] == 0, \
        "the exact-navigation sharded build differs from the batched one"
    out["exact_build"] = exact
    out["launches"] = ops.snapshot()
    return out


# ---------------------------------------------------------------------------
# phase 11: the LM serving path and retrieval-fed generation
# ---------------------------------------------------------------------------

LM_TOL = 1e-4                   # card against the CPU, float32
DECODE_TOL = 2e-3               # decode against the forward (as
                                # tests/test_models_smoke.py holds JAX)
# the smoke archs whose prefill + decode is held against the forward on the
# card (tests/test_models_smoke.py's four)
LM_DECODE_ARCHS = ("qwen2-7b", "mamba2-2.7b", "jamba-v0.1-52b",
                   "mixtral-8x22b")
# sizes of the full-width runs: float32 checks (batch, forward length,
# prefill length, decode steps), the blockwise-attention check's length,
# the timed runs through launch.serve (requests, prompt, new tokens), the
# mixtral depth cut, and the RAG requests, their new tokens and the
# corpus's tokens per document
LM_SIZES = {"qwen2-1.5b": (2, 64, 48, 16), "mamba2-2.7b": (2, 300, 256, 16),
            "mixtral-8x22b": (1, 6144, 5120, 8), "blockwise_s": 4096,
            "serve": (8, 512, 32), "mixtral_repeat": 2,
            "rag": (16, 16, 24)}


def _max_err(label, got, want, tol) -> float:
    """Max |got − want| (both moved to the CPU as float32); fails past
    rtol = atol = ``tol``."""
    import torch
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape, f"{label}: shapes differ"
    assert bool(torch.isfinite(got).all()), f"{label}: not finite"
    assert torch.allclose(got, want, rtol=tol, atol=tol), \
        f"{label}: off by {float((got - want).abs().max())}"
    return float((got - want).abs().max())


def _lm_batch(cfg, b: int, s: int, seed: int) -> dict:
    """tests/test_models_smoke.py's batch as CPU tensors: tokens, or the
    audio / vision stub frontends' embeddings."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.from_numpy(rng.normal(
            0, 1, (b, s, cfg.d_model)).astype(np.float32))}
    out = {}
    if cfg.frontend == "vision":
        p = cfg.vision_prefix
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (b, p, cfg.d_model)).astype(np.float32))
        s -= p
    out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    return out


def _decode_vs_forward(label, model, cfg, tokens, prefix: int,
                       steps: int = 0) -> dict:
    """The forward over all of ``tokens``, then a prefill of
    ``tokens[:, :prefix]`` and ``steps`` decode steps (all the rest with
    0): the prefill's last logits and every step's within DECODE_TOL of the
    forward's at the same position."""
    from repro_torch.models import lm
    b, s = tokens.shape
    steps = steps or s - prefix
    full, _ = lm.lm_forward(model, cfg, {"tokens": tokens})
    want = full[:, prefix - 1:prefix + steps].clone()
    del full
    logits, caches = lm.lm_prefill(model, cfg, {"tokens": tokens[:, :prefix]},
                                   prefix + steps + 8)
    errs = [_max_err(f"{label} prefill", logits[:, 0], want[:, 0],
                     DECODE_TOL)]
    for i in range(prefix, prefix + steps):
        logits, caches = lm.lm_decode_step(model, caches, cfg,
                                           tokens[:, i:i + 1])
        errs.append(_max_err(f"{label} decode {i}", logits[:, 0],
                             want[:, i - prefix + 1], DECODE_TOL))
    return {"forward_s": s, "prefix": prefix, "steps": steps,
            "max_abs_err": max(errs)}


def lm_card_vs_cpu(dev) -> dict:
    """Every arch's smoke config on the card and on the CPU with the same
    weights (forward logits within LM_TOL), and prefill + decode against
    the forward on the card for LM_DECODE_ARCHS and the sliding-window
    ring (mixtral, 48 tokens past its window of 32)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import list_archs, smoke_config
    from repro_torch.models import lm

    out = {"forward": {}, "decode": {}}
    for arch in list_archs():
        cfg = smoke_config(arch)
        cpu = lm.init_lm(cfg, 0, "cpu")
        card = copy.deepcopy(cpu).to(dev)
        batch = _lm_batch(cfg, 2, 32, 0)
        want, waux = lm.lm_forward(cpu, cfg, batch)
        got, gaux = lm.lm_forward(card, cfg, {k: v.to(dev)
                                              for k, v in batch.items()})
        out["forward"][arch] = _max_err(f"{arch} card vs CPU", got, want,
                                        LM_TOL)
        for k in waux:
            _max_err(f"{arch} {k}", gaux[k], waux[k], LM_TOL)
        runs = [(24, 16, 2)] if arch in LM_DECODE_ARCHS else []
        if arch == "mixtral-8x22b":
            runs.append((48, 40, 1))              # past the window: the ring
        for s, prefix, b in runs:
            tokens = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab, (b, s))).to(dev)
            out["decode"][f"{arch}/s{s}"] = _decode_vs_forward(
                f"{arch} s={s}", card, cfg, tokens, prefix)
        del cpu, card
    return out


def _serve_run(dev, arch: str, *extra) -> dict:
    """One timed ``launch.serve.main`` run at the config's own dtypes."""
    import torch
    from repro_torch.launch import serve
    n_req, prompt, new = LM_SIZES["serve"]
    torch.cuda.empty_cache()
    res = serve.main(["--arch", arch, "--requests", str(n_req),
                      "--prompt-len", str(prompt), "--new-tokens", str(new),
                      "--device", str(dev), *extra])
    del res["first_request"]
    return res


def lm_full(dev, index, ds) -> dict:
    """Three configs at their published widths: float32 checks of prefill
    + decode against the forward (and of blockwise against full attention
    for qwen), then timed runs through ``launch.serve.main`` in the
    configs' bfloat16 compute; the RAG requests run on the qwen model
    between its check and its timed run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    out = {"reduced": []}

    def f32_check(label, cfg, seed):
        b, s, prefix, steps = LM_SIZES[label]
        assert s >= prefix + steps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm.init_lm(cfg, 0, dev)
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (b, s))).to(dev)
        t0 = time.perf_counter()
        row = _decode_vs_forward(label, model, cfg, tokens, prefix, steps)
        torch.cuda.synchronize(dev)
        row.update(seconds=time.perf_counter() - t0, batch=b,
                   layers=cfg.n_layers, d_model=cfg.d_model,
                   params=lm.param_count(cfg),
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        return model, row

    # qwen2-1.5b: all 28 layers
    qcfg = get_config("qwen2-1.5b")
    model, out["qwen2-1.5b"] = f32_check(
        "qwen2-1.5b", dataclasses.replace(qcfg, compute_dtype="float32"),
        1)
    s = LM_SIZES["blockwise_s"]
    cfg32 = dataclasses.replace(qcfg, compute_dtype="float32")
    assert s > cfg32.attn_chunk_threshold
    x = torch.randn((1, s, cfg32.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    pos = torch.arange(s, device=dev)[None]
    q, k, v = A._project_qkv(model.segments[0][0][0].attn, x, cfg32, pos)
    out["qwen2-1.5b"]["blockwise_vs_full"] = {
        "s": s, "max_abs_err": _max_err(
            "qwen blockwise vs full", A.blockwise_attention(q, k, v,
                                                            cfg32),
            A.full_attention(q, k, v, cfg32), DECODE_TOL)}
    del x, q, k, v
    out["rag"] = lm_rag(dev, index, ds, model, qcfg)
    del model
    out["qwen2-1.5b"]["serve"] = _serve_run(dev, "qwen2-1.5b")

    # mamba2-2.7b: all 64 layers
    mcfg = get_config("mamba2-2.7b")
    model, out["mamba2-2.7b"] = f32_check(
        "mamba2-2.7b", dataclasses.replace(mcfg, compute_dtype="float32"),
        3)
    del model
    out["mamba2-2.7b"]["serve"] = _serve_run(dev, "mamba2-2.7b")

    # mixtral-8x22b: published widths, depth cut
    rep = LM_SIZES["mixtral_repeat"]
    xcfg = get_config("mixtral-8x22b")
    (full_rep, period), = xcfg.segments
    xcfg = dataclasses.replace(xcfg, segments=((rep, period),),
                               n_layers=rep * len(period))
    out["reduced"].append(
        f"mixtral-8x22b: {full_rep} -> {rep} layers (the 56 layers' "
        f"{lm.param_count(get_config('mixtral-8x22b')):,} parameters "
        f"do not fit on one card)")
    _, s, prefix, _ = LM_SIZES["mixtral-8x22b"]
    assert prefix > xcfg.window and prefix % xcfg.attn_chunk_q == 0
    drop_free = dataclasses.replace(xcfg, compute_dtype="float32",
                                    moe=dataclasses.replace(
                                        xcfg.moe, capacity_factor=8.0))
    model, out["mixtral-8x22b"] = f32_check("mixtral-8x22b", drop_free,
                                            4)
    out["mixtral-8x22b"]["capacity_factor"] = 8.0
    # the share of assignments the timed run's prompts drop at the
    # published capacity factor: the same weights (seed 0) and prompts
    # (launch.serve's rng) through the forward, the mean over layers
    n_req, prompt, _ = LM_SIZES["serve"]
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, xcfg.vocab, (n_req, prompt)).astype(np.int32)).to(dev)
    _, aux = lm.lm_forward(model, xcfg, {"tokens": prompts})
    del model, prompts
    out["mixtral-8x22b"]["serve"] = _serve_run(
        dev, "mixtral-8x22b", "--max-repeat", str(rep))
    out["mixtral-8x22b"]["serve"]["drop_frac"] = \
        float(aux["drop_frac"]) / xcfg.n_layers
    out["mixtral-8x22b"]["serve"]["capacity_factor"] = \
        xcfg.moe.capacity_factor
    return out


def lm_rag(dev, index, ds, model, cfg) -> dict:
    """Retrieval-fed generation on the full-size corpus: LM_SIZES["rag"]
    DSL requests (label, range, hybrid and Tag ∧ Num filters over the
    phase-4 queries) admitted to a ``RetrievalFrontend`` on the phase-5
    ``Index`` and flushed once, every match checked against the source
    arrays; prompts built with ``context_tokens`` from a seeded (N, 24)
    token table over the model's vocabulary, and greedy ``generate`` on
    them, one batch per prompt length, with the model in the config's
    compute dtype. The kernel launches of the retrieval are returned under
    ``launches``."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api.session import SessionConfig
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import RetrievalFrontend, generate

    n_req, n_new, doc_len = LM_SIZES["rag"]
    nq = ds.queries.shape[0]
    kinds = ("label", "range", "hybrid", "tag_and_num")
    reqs = [dsl_request(api, ds, i % nq, kinds[i % 4], "tag")
            for i in range(n_req)]
    out = {"requests": n_req, "kinds": kinds}
    frontend = RetrievalFrontend(index, SessionConfig(
        max_batch=n_req, max_delay_s=1e9, auto_flush=False))
    before = ops.snapshot()
    with entry_calls("hop_fused_gather", "hop_fused", "or_scatter_",
                     "or_scatter_new", "or_scatter", "pq_scan_gather",
                     "pq_scan") as calls:
        t0 = time.perf_counter()
        handles = [frontend.submit(r.query, r.filter) for r in reqs]
        assert frontend.flush() == n_req
        results = [h.result() for h in handles]
        out["retrieval_s"] = time.perf_counter() - t0
    after = ops.snapshot()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["entry_calls"] = dict(calls)
    out["batches"] = frontend.session.n_batches
    assert out["batches"] == 1, "the requests did not share one flush"
    assert calls["or_scatter_"] > 0 and out["launches"]["hop_fused"] > 0, \
        "the retrieval launched no hop kernels"
    assert calls["hop_fused"] == calls["or_scatter"] == \
        calls["pq_scan"] == 0, "a slab entry was called in the RAG flow"

    off, flat, vals = ds.label_offsets, ds.label_flat, ds.values
    n_checked = 0
    for i, (r, res) in enumerate(zip(reqs, results)):
        labels = ds.query_labels[i % nq]
        lo, hi = ds.query_ranges[i % nq]
        for j, _, _ in res.matches:
            tags = set(flat[off[j]:off[j + 1]].tolist())
            in_range = bool(lo <= vals[j] < hi)
            ok = {"label": labels[0] in tags, "range": in_range,
                  "hybrid": bool(tags & set(labels)) or in_range,
                  "tag_and_num": labels[0] in tags and in_range}[
                      kinds[i % 4]]
            assert ok, f"RAG request {i}: id {j} outside its filter"
            n_checked += 1
    out["matches"] = n_checked
    out["matches_by_kind"] = {
        kind: sum(len(results[i].matches) for i in range(n_req)
                  if kinds[i % 4] == kind) for kind in kinds}
    out["mechanisms"] = dict(collections.Counter(
        res.stats.mechanism for res in results))

    rng = np.random.default_rng(5)
    docs = rng.integers(0, cfg.vocab, (ds.vectors.shape[0], doc_len),
                        dtype=np.int32)
    questions = rng.integers(0, cfg.vocab, (n_req, 8), dtype=np.int32)
    prompts = [np.concatenate([RetrievalFrontend.context_tokens(
        res, docs, per_doc=8), questions[i]]).astype(np.int32)
        for i, res in enumerate(results)]
    # one generate call per prompt length (requests with fewer matches
    # have shorter prompts): the batch a server would form
    groups = collections.defaultdict(list)
    for i, p in enumerate(prompts):
        groups[len(p)].append(i)
    serving = lm.cast_for_compute(model)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tokens = [None] * n_req
    for idx in groups.values():
        toks = generate(serving, cfg, np.stack([prompts[i] for i in idx]),
                        n_new).cpu()
        assert toks.shape == (len(idx), n_new)
        assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
        for i, row in zip(idx, toks.tolist()):
            tokens[i] = row
    out["generate_s"] = time.perf_counter() - t0
    out.update(new_tokens=n_new, compute_dtype=cfg.compute_dtype,
               prompt_lens={n: len(idx) for n, idx in groups.items()},
               first_tokens=tokens[0])
    del serving
    return out


def lm_phase(dev, index, ds) -> dict:
    """Phase 11: the LM serving path on the card. Nothing here is caught: a
    failed check fails the run."""
    import torch
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "float32 checks need TF32 off (PyTorch's default)"
    out = {}
    t0 = time.perf_counter()
    out["card_vs_cpu"] = lm_card_vs_cpu(dev)
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "lm_card_vs_cpu", **out["card_vs_cpu"]})
    t0 = time.perf_counter()
    full = lm_full(dev, index, ds)
    out["rag"] = full.pop("rag")
    emit({"phase": "rag", **out["rag"]})
    out["full"] = full
    out["full"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "lm_full", **out["full"]})
    out["launches"] = out["rag"]["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 12: the LM training path
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("qwen2-1.5b", "mamba2-2.7b", "mixtral-8x22b")
# the full-width run (batch, sequence, steps) and the resume drill (steps,
# checkpoint interval, the step that fails once, batch, sequence)
TRAIN_SIZES = {"full": (4, 512, 8), "resume": (6, 2, 5, 4, 64)}
TRAIN_DIR = ROOT / "build" / "smoke_train"
# the card-vs-CPU AdamW step at launch.train's settings (first-step lr
# 1e-4): a first step maps each gradient g to about lr · g / (|g| + eps),
# so a gradient of ~1e-8 that the card computes 5e-10 off moves its
# parameter by ~0.013 lr (at lr 1e-2, 1.3e-4: past the 1e-4 bar)
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 10}


def _same_params(label, a, b) -> None:
    import torch
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters(),
                                 strict=True):
        assert torch.equal(p.detach().cpu(), q.detach().cpu()), \
            f"{label}: {name} differs"


def train_card_vs_cpu(dev) -> dict:
    """Smoke widths, float32, TF32 off: loss and every gradient leaf of
    TRAIN_ARCHS, and the parameters after one AdamW step with float32 and
    with int8 moments, card against CPU from the same weights (within
    LM_TOL); ``compressed_psum_grads`` at S = 4 over two rounds of error
    feedback, threefry keys, bits, uniform, gumbel and categorical draws,
    and sampled ``generate`` on qwen2-1.5b, each equal to the CPU's."""
    import copy
    import numpy as np
    import torch
    from repro_torch import random as R
    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import lm
    from repro_torch.serve import generate
    from repro_torch.train import grad_compress, optim, train_loop

    out = {}
    qwen_grads = None
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(arch)
        cpu = lm.init_lm(cfg, 0, "cpu")
        batch = lm_batch(cfg, 4, 32, 0)
        wl, _, wg = train_loop.loss_and_grads(cpu, cfg, batch)
        gl, _, gg = train_loop.loss_and_grads(copy.deepcopy(cpu).to(dev),
                                              cfg, batch)
        row = {"loss": float(wl), "loss_err": _max_err(
            f"{arch} loss", gl, wl, LM_TOL), "grad_leaves": len(wg),
            "grads_err": max(_max_err(f"{arch} grad {k}", gg[k], wg[k],
                                      LM_TOL) for k in wg)}
        for int8 in (False, True):
            ocfg = optim.OptConfig(**TRAIN_OPT, int8_moments=int8)
            stepped = []
            for model in (copy.deepcopy(cpu), copy.deepcopy(cpu).to(dev)):
                step = train_loop.make_train_step(cfg, ocfg)
                model, _, _ = step(model, optim.init_opt_state(model, ocfg),
                                   batch)
                stepped.append(model)
            row["step_int8_err" if int8 else "step_f32_err"] = max(
                _max_err(f"{arch} step {n}", q, p, LM_TOL)
                for (n, p), (_, q) in zip(stepped[0].named_parameters(),
                                          stepped[1].named_parameters()))
        out[arch] = row
        if arch == "qwen2-1.5b":
            qwen_grads = wg
        del cpu, stepped

    # the int8 error-feedback reduction over 4 shards, the same inputs
    factors = (1.0, -0.5, 2.0, 0.25)
    cpu_g = [{k: g * f for k, g in qwen_grads.items()} for f in factors]
    card_g = [{k: g.to(dev) for k, g in t.items()} for t in cpu_g]
    e_cpu = [grad_compress.init_error_feedback(t) for t in cpu_g]
    e_card = [grad_compress.init_error_feedback(t) for t in card_g]
    for _ in range(2):
        m_cpu, e_cpu = grad_compress.compressed_psum_grads(cpu_g, e_cpu)
        m_card, e_card = grad_compress.compressed_psum_grads(card_g, e_card)
        for k in m_cpu:
            assert torch.equal(m_card[k].cpu(), m_cpu[k]), f"psum mean {k}"
            for s in range(len(factors)):
                assert torch.equal(e_card[s][k].cpu(), e_cpu[s][k]), \
                    f"psum error feedback {s} {k}"
    out["compressed_psum"] = {"shards": len(factors), "rounds": 2,
                              "leaves": len(m_cpu), "equal": True}

    # threefry draws
    draws = {}
    for where in ("cpu", dev):
        key = R.PRNGKey(7, device=where)
        logits = torch.from_numpy(np.random.default_rng(7).normal(
            0, 3, (4, 151936)).astype(np.float32)).to(where)
        draws[str(where)] = {
            "split": R.split(key, 5), "bits": R.random_bits(key, (3, 1000)),
            "uniform": R.uniform(key, (3, 1000), -2.5, 3.7),
            "gumbel": R.gumbel(key, (4, 151936)),
            "categorical": R.categorical(key, logits)}
    for name, want in draws["cpu"].items():
        assert torch.equal(draws[str(dev)][name].cpu(), want), \
            f"threefry {name}: card differs"
    out["threefry"] = {"draws": sorted(draws["cpu"]), "equal": True}

    cfg = smoke_config("qwen2-1.5b")
    cpu = lm.init_lm(cfg, 0, "cpu")
    prompts = np.random.default_rng(11).integers(0, cfg.vocab, (3, 20))
    want = generate(cpu, cfg, prompts, 12, temperature=1.0, seed=11)
    got = generate(copy.deepcopy(cpu).to(dev), cfg, prompts, 12,
                   temperature=1.0, seed=11).cpu()
    assert torch.equal(got, want), "sampled generate: card differs"
    assert not torch.equal(want, generate(cpu, cfg, prompts, 12))
    out["sampled_generate"] = {"tokens": list(want.shape), "equal": True}
    return out


def _profile_step(fn, dev) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activities): wall seconds, the device's busy time (the sum of the
    CUDA kernels' self time), its idle share, and the kernel count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": [
                [e.key[:100], e.count, e.self_device_time_total / 1e3]
                for e in sorted(kernels, key=lambda e:
                                -e.self_device_time_total)[:8]]}


def train_full(dev) -> dict:
    """``launch.train.main`` on qwen2-1.5b at its published widths (float32
    parameters, bfloat16 compute, remat on), TRAIN_SIZES["full"], no save:
    finite losses that fall, step seconds, tokens/s, PyTorch calls a step
    (counted on the CPU at the real depth and tiny widths), peak memory,
    the step's bound at ``launch.roofline.BF16_FLOPS`` and, through
    ``--mesh local``, the mesh and its per-device parameter bytes; then
    one more step under ``torch.profiler`` for the device's busy time and
    idle share."""
    import math
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.roofline import BF16_FLOPS

    cfg = get_config("qwen2-1.5b")
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) == \
        ("float32", "bfloat16", True)
    b, s, steps = TRAIN_SIZES["full"]
    ckpt = TRAIN_DIR / "full"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    res = train.main(["--arch", "qwen2-1.5b", "--steps", str(steps),
                      "--batch", str(b), "--seq", str(s), "--ckpt-dir",
                      str(ckpt), "--ckpt-every", str(steps + 1),
                      "--mesh", "local", "--device", str(dev)])
    assert res["mesh"] == {"data": 1, "model": torch.cuda.device_count()}
    model, opt = res.pop("params_module"), res.pop("opt_state")
    from repro_torch.data.tokens import lm_batch
    from repro_torch.train import OptConfig, make_train_step
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=10,
                                          total_steps=steps))
    batch = lm_batch(cfg, b, s, steps)
    res["profiled_step"] = _profile_step(lambda: step(model, opt, batch),
                                         dev)
    del model, opt, step
    torch.cuda.empty_cache()
    losses = res["losses"]
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), \
        f"train_full: losses {losses}"
    assert losses[-1] < losses[0], f"train_full: loss did not fall {losses}"
    assert not list(ckpt.glob("step_*")), "train_full saved a checkpoint"
    res.update(torch_ops_per_step=train.count_step_ops(cfg, b, s),
               loss_first=losses[0], loss_last=losses[-1],
               bound_rate=f"{BF16_FLOPS:.4g} FLOP/s, H100 SXM dense "
               "bfloat16 (data sheet)", d_model=cfg.d_model,
               vocab=cfg.vocab)
    return res


def train_resume(dev) -> dict:
    """Smoke width on the card: a run of TRAIN_SIZES["resume"] steps whose
    step after the step-4 checkpoint fails once ends with the parameters
    of an uninterrupted run, and its latest checkpoint restores through
    ``CheckpointManager`` into a fresh model equal to the uninterrupted
    run's checkpoint of the same step."""
    import shutil
    from repro_torch.ckpt import ArraySpec, CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.train_loop import load_train_state, \
        train_state_tree
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    steps, every, fail, b, s = TRAIN_SIZES["resume"]
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    common = ["--arch", "qwen2-1.5b", "--smoke", "--steps", str(steps),
              "--ckpt-every", str(every), "--batch", str(b), "--seq",
              str(s), "--device", str(dev)]
    whole = train.main(common + ["--ckpt-dir", str(TRAIN_DIR / "whole")])
    drill = train.main(common + ["--ckpt-dir", str(TRAIN_DIR / "drill"),
                                 "--fail-at-step", str(fail)])
    assert drill["retries"] == 1 and drill["final_step"] == steps
    assert drill["losses"] == whole["losses"], "resumed losses differ"
    _same_params("resume", drill["params_module"], whole["params_module"])

    cfg = smoke_config("qwen2-1.5b")
    fresh = lm.init_lm(cfg, 5, dev)
    opt = init_opt_state(fresh, OptConfig())
    target = tree_map(lambda x: ArraySpec(x.shape, x.dtype),
                      train_state_tree(cfg, fresh, opt))
    saved, tree = CheckpointManager(str(TRAIN_DIR / "drill")).restore(target)
    opt = load_train_state(cfg, tree, fresh, opt)
    assert saved == fail - 1 and int(opt.step) == fail
    _, want = CheckpointManager(str(TRAIN_DIR / "whole")).restore(
        target, step=saved)
    got = train_state_tree(cfg, fresh, opt)
    for (path, x), (_, y) in zip(tree_flatten_with_path(got),
                                 tree_flatten_with_path(want), strict=True):
        assert (x == y).all(), f"restored {path} differs"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return {"steps": steps, "ckpt_every": every, "failed_at": fail,
            "restored_step": saved, "resumed_at_step": int(opt.step),
            "losses": whole["losses"], "params_equal": True,
            "restored_equal": True}


def train_phase(dev) -> dict:
    """Phase 12: the LM training path on the card. Nothing here is caught:
    a failed check fails the run. No kernel lies on this path; its
    launches are counted all the same."""
    import torch
    from repro_torch.kernels import ops
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "float32 checks need TF32 off (PyTorch's default)"
    torch.cuda.empty_cache()
    before = ops.snapshot()
    out = {}
    for name, fn in (("train_card_vs_cpu", train_card_vs_cpu),
                     ("train_full", train_full),
                     ("train_resume", train_resume)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **out[name]})
    after = ops.snapshot()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


# the split-K decode run: requests, prompt tokens, cache slots (decode_32k's
# length) and greedy new tokens, and the local mesh's model-axis width
MESH_SIZES = {"sp": (8, 512, 32768, 16), "shards": 4}
MESH_DIR = ROOT / "build" / "smoke_dryrun"


def _greedy(model, cfg, prompts, max_t: int, new: int):
    """Prefill ``prompts`` into caches of ``max_t`` slots, then ``new`` - 1
    greedy decode steps: (tokens (B, new), every step's logits)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.decode import sample_token
    with torch.inference_mode():
        logits, caches = lm.lm_prefill(model, cfg, {"tokens": prompts},
                                       max_t)
        out, seen = [sample_token(logits)], [logits]
        for _ in range(new - 1):
            logits, caches = lm.lm_decode_step(model, caches, cfg, out[-1])
            out.append(sample_token(logits))
            seen.append(logits)
    return torch.cat(out, dim=1), torch.cat(seen, dim=1)


def sp_decode_run(dev) -> dict:
    """qwen2-1.5b at its published widths, MESH_SIZES["sp"]: the plain
    decode, then ``sp_decode=True`` under ``make_local_mesh(1, S)`` (the
    KV cache split into S ``narrow`` views, the logsumexp merge). In
    float32 (TF32 off): greedy tokens equal and every step's logits within
    DECODE_TOL, with every attention layer of every step through
    ``_sp_decode_core``. In the config's bfloat16: ms/token of both through
    ``generate`` (median of steps 2 on), PyTorch calls a step and the
    step's bytes bound (weights once plus the KV read, at the HBM rate)."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import HBM_BYTES_PER_S
    from repro_torch.launch.serve import step_read_bytes, torch_ops
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.models.common import (clear_activation_sharding,
                                           set_activation_sharding)
    from repro_torch.serve.decode import generate, make_decode_step

    b, prompt, slots, new = MESH_SIZES["sp"]
    shards = MESH_SIZES["shards"]
    cfg = get_config("qwen2-1.5b")
    assert cfg.window == 0 and slots % shards == 0
    mesh = make_local_mesh(1, shards, dev)
    prompts = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (b, prompt)).astype(np.int32)).to(dev)
    calls = [0]
    core = A._sp_decode_core

    def counted_core(*a, **k):
        calls[0] += 1
        return core(*a, **k)

    out = {"batch": b, "prompt": prompt, "cache_slots": slots,
           "new_tokens": new, "shards": shards, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv]}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = lm.init_lm(cfg32, 0, dev)
    t0 = time.perf_counter()
    want_tok, want_logits = _greedy(model, cfg32, prompts, slots, new)
    A._sp_decode_core = counted_core
    set_activation_sharding(mesh, ("data",))
    try:
        got_tok, got_logits = _greedy(
            model, dataclasses.replace(cfg32, sp_decode=True), prompts,
            slots, new)
    finally:
        clear_activation_sharding()
        A._sp_decode_core = core
    torch.cuda.synchronize(dev)
    assert calls[0] == cfg.n_layers * (new - 1), \
        f"split-K ran {calls[0]} times, not {cfg.n_layers * (new - 1)}"
    assert torch.equal(got_tok, want_tok), "sp_decode: greedy tokens differ"
    out["float32"] = {
        "tokens_equal": True, "sp_core_calls": calls[0],
        "max_abs_err": _max_err("sp_decode logits", got_logits,
                                want_logits, DECODE_TOL),
        "seconds": time.perf_counter() - t0}
    del model, want_logits, got_logits

    # bfloat16 (the config's compute dtype): the timed runs
    torch.cuda.empty_cache()
    model = lm.init_lm(cfg, 0, dev)
    rows = {}
    for name, sp in (("plain", False), ("split_k", True)):
        run_cfg = dataclasses.replace(cfg, sp_decode=sp)
        if sp:
            set_activation_sharding(mesh, ("data",))
        try:
            timings = {}
            toks = generate(model, run_cfg, prompts, new, max_t=slots,
                            timings=timings)
            serving = lm.cast_for_compute(model)
            with torch.inference_mode():
                _, caches = lm.lm_prefill(serving, run_cfg,
                                          {"tokens": prompts}, slots)
            step = make_decode_step(run_cfg)
            ops = torch_ops(lambda: step(serving, caches, toks[:, :1]))
            read = step_read_bytes(serving, caches)
        finally:
            clear_activation_sharding()
        del serving, caches
        steps = timings["step_s"][1:]
        ms = statistics.median(steps) * 1e3
        rows[name] = {"prefill_s": timings["prefill_s"],
                      "decode_ms_per_token": ms,
                      "decode_tok_s": b / (ms / 1e3),
                      "torch_ops_per_step": ops, "step_read_bytes": read,
                      "step_bound_ms": read / HBM_BYTES_PER_S * 1e3,
                      "tokens": toks.cpu()}
    # bfloat16 tokens may part on near-ties: reported, held in float32
    rows["split_k"]["bf16_tokens_equal"] = bool(torch.equal(
        rows["split_k"].pop("tokens"), rows["plain"].pop("tokens")))
    rows["split_k"]["ms_ratio"] = rows["split_k"]["decode_ms_per_token"] \
        / rows["plain"]["decode_ms_per_token"]
    out["bfloat16"] = rows
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del model
    torch.cuda.empty_cache()
    return out


def dryrun_run() -> dict:
    """``launch.dryrun.run_cell("qwen2-1.5b", "decode_32k", "single")`` and
    ``launch.dryrun_ann.run("single")``, both on ``meta`` (the search's
    hop counted on a small CPU store), status ok, with their per-card
    bytes and roofline terms (analytic, at the H100 SXM data sheet's
    rates)."""
    import shutil
    from repro_torch.launch import dryrun, dryrun_ann
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    out = {}
    for name, r in (("qwen2-1.5b/decode_32k",
                     dryrun.run_cell("qwen2-1.5b", "decode_32k", "single",
                                     str(MESH_DIR))),
                    ("ann_search/single",
                     dryrun_ann.run("single", str(MESH_DIR)))):
        assert r["status"] == "ok", f"dry-run {name}: {r.get('error')}"
        out[name] = {"n_chips": r["n_chips"], "memory": r["memory"],
                     "roofline": r["roofline"],
                     "collective_bytes": r["counted"]["collective_bytes"],
                     "flops_per_chip": r["counted"]["flops_per_chip"],
                     "bytes_per_chip": r["counted"]["bytes_per_chip"]}
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out


def mesh_phase(dev) -> dict:
    """Phase 13: the mesh and launch tooling. Nothing here is caught: a
    failed check fails the run. No kernel lies on this path; its launches
    are counted all the same."""
    import torch
    from repro_torch.kernels import ops
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "float32 checks need TF32 off (PyTorch's default)"
    before = ops.snapshot()
    out = {}
    for name, fn in (("sp_decode", lambda: sp_decode_run(dev)),
                     ("dryrun", dryrun_run)):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **out[name]})
    after = ops.snapshot()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


# ---------------------------------------------------------------------------
# phase 14: the range route at 768 dimensions, M = 64, two numeric fields
# ---------------------------------------------------------------------------

# the benchmark cell whose configuration and traffic phase 14 serves, the
# corpus rows it keeps of them and the counted batches
WIDE_CELL = "hbm-laion.range2-c64"
WIDE_N = 50_000
WIDE_REPEATS = 5


def wide_phase(dev) -> dict:
    """Phase 14: the LAION-shaped range deployment (``annbench``'s
    ``WIDE_CELL``: d 768, PQ M 64, numeric fields width and similarity) cut
    to ``WIDE_N`` records, built on the card through the harness's
    ``build_index``, and the first 64 requests of its pool (range filters
    over either field) through ``Index.search_batch``. Every returned id is
    checked for exact membership, and each ``pre`` row calls
    ``ops.pq_scan_gather`` once. Then the requests routed ``in`` run alone,
    warmed once (hop graphs captured) and counted over ``WIDE_REPEATS``
    batches: ``hop_fused`` launches one a hop step, each through
    ``ops.hop_fused_gather``, and every hop step is a graph replay."""
    import copy
    import torch
    from annbench import harness, loadgen
    from annbench.corpus import make_corpus
    from repro_torch.kernels import ops

    files = harness.cell_files(harness.load_bench(ROOT), WIDE_CELL, ROOT)
    config, traffic = copy.deepcopy(files["config"]), files["traffic"]
    config["corpus"]["n"] = WIDE_N
    before = ops.snapshot()
    t0 = time.perf_counter()
    corpus = make_corpus(config["corpus"], 0, traffic["pool"])
    reqs = harness.make_requests(loadgen.make_pool(traffic, corpus, 0),
                                 traffic)[:64]
    index = harness.build_index(config, corpus, dev)
    e = index.engine
    out = {"cell": WIDE_CELL, "n": WIDE_N, "d": int(corpus.vectors.shape[1]),
           "pq_m": int(e.codes.shape[1]), "fields": list(index.schema.nums),
           "setup_s": time.perf_counter() - t0}
    assert (out["d"], out["pq_m"], e.n_fields) == (768, 64, 2), out

    with entry_calls("pq_scan_gather") as calls:
        results, stats = index.search_batch(reqs, with_stats=True)
    mech = stats.mechanism
    out["mechanisms"] = {m: mech.count(m) for m in sorted(set(mech))}
    assert calls["pq_scan_gather"] == mech.count("pre"), \
        f"wide: {calls['pq_scan_gather']} pq_scan_gather calls"
    out["checked_ids"] = _check_served("wide", index, reqs, results)

    in_reqs = [r for r, m in zip(reqs, mech) if m == "in"]
    assert in_reqs, "wide: no request took the in route"
    index.search_batch(in_reqs)                 # warm-up: captures
    steps = graphed = captures = 0
    lat = []
    mid = ops.snapshot()
    with entry_calls("hop_fused_gather") as calls:
        for _ in range(WIDE_REPEATS):
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            results, stats = index.search_batch(in_reqs, with_stats=True)
            lat.append(time.perf_counter() - t1)
            assert set(stats.mechanism) == {"in"}, "wide: routes moved"
            steps += stats.trace["hop_steps"]
            graphed += stats.trace["hop_steps_graphed"]
            captures += stats.trace["graph_captures"]
    hop_launches = ops.snapshot()["hop_fused"] - mid["hop_fused"]
    out["checked_ids"] += _check_served("wide/in", index, in_reqs, results)
    assert captures == 0, f"wide: {captures} captures in the counted batches"
    assert steps > 0 and graphed == (steps if dev.type == "cuda" else 0), \
        f"wide: {graphed} of {steps} hop steps graphed"
    assert hop_launches == calls["hop_fused_gather"] == steps, \
        (f"wide: {hop_launches} hop_fused launches, "
         f"{calls['hop_fused_gather']} gathered calls, {steps} hop steps")
    out["in"] = {"queries": len(in_reqs), "batches": WIDE_REPEATS,
                 "hop_steps_per_batch": steps / WIDE_REPEATS,
                 "hop_fused_launches_per_hop_step": hop_launches / steps,
                 "p50_batch_ms": sorted(lat)[len(lat) // 2] * 1e3}
    after = ops.snapshot()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


# ---------------------------------------------------------------------------

KERNELS = {
    "hop_fused": ("hop_fused/gather",
                  "src/repro_torch/kernels/csrc/hop_fused.cu",
                  "src/repro/kernels/hop_fused.py:142"),
    "or_scatter": ("or_scatter/visited_inplace",
                   "src/repro_torch/kernels/csrc/or_scatter.cu",
                   "src/repro/kernels/or_scatter.py:61"),
    "prune_scan": ("prune_scan/C96/a2=1.44",
                   "src/repro_torch/kernels/csrc/prune_scan.cu",
                   "src/repro/kernels/prune_scan.py:58"),
    "pq_scan": ("pq_scan/scan", "src/repro_torch/kernels/csrc/pq_scan.cu",
                "src/repro/kernels/pq_scan.py:48"),
    "approx_probe": ("approx_probe/1M",
                     "src/repro_torch/kernels/csrc/approx_probe.cu",
                     "src/repro/kernels/approx_probe.py:83"),
    "l2_rerank": ("l2_rerank/1Mx192",
                  "src/repro_torch/kernels/csrc/l2_rerank.cu",
                  "src/repro/kernels/l2_rerank.py:35"),
}
# phase-2 rows reported beside a kernel's own: the slab entry of hop_fused
# (the main path launches the gathered one) and the gathered one at phase
# 10's shard widths and at M = 64 with two bucket fields (phase 14's
# widths), or_scatter's fresh-table rows (the seeding's) and its
# out-of-place slab entry's two rows, the no-prune row of prune_scan and
# its rows at phase 10's shard widths, pq_scan's cold-L2 scan and
# pre-route rows (the slab entry and the gathered one the pre route
# launches) and its scan and gathered rows at M = 64, approx_probe's
# cold-L2 and 100,000-row rows
BESIDE = {"hop_fused": ("hop_fused", "hop_fused/gather/B32",
                        "hop_fused/gather/B16", "hop_fused/gather/M64"),
          "or_scatter": ("or_scatter/visited_new", "or_scatter/rare_list_new",
                         "or_scatter/visited", "or_scatter/rare_list"),
          "prune_scan": ("prune_scan/C96/noprune",
                         "prune_scan/C96/a2=1.44/B512",
                         "prune_scan/C96/a2=1.44/B256"),
          "pq_scan": ("pq_scan/scan_cold", "pq_scan/pre",
                      "pq_scan/pre_gather", "pq_scan/scan/M64",
                      "pq_scan/pre_gather/M64"),
          "approx_probe": ("approx_probe/1M_cold", "approx_probe/100k")}
# the phase whose run counts each kernel's launches
LAUNCH_PHASE = {"hop_fused": "full", "or_scatter": "full",
                "prune_scan": "full", "pq_scan": "serve",
                "approx_probe": "ops", "l2_rerank": "ops"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=FULL_N,
                    help="corpus size of the full-size phase")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    kern = kernel_phase(dev)
    emit({"phase": "kernels_vs_plain", **kern})

    t0 = time.perf_counter()
    small = card_vs_cpu_phase(dev)
    emit({"phase": "card_vs_cpu", "seconds": time.perf_counter() - t0,
          **small})

    t0 = time.perf_counter()
    wide = wide_phase(dev)
    wide["seconds"] = time.perf_counter() - t0
    emit({"phase": "wide", **wide})

    # halve N while the full-size phase would not fit in the time limit
    n, cuts = args.n, []
    elapsed = time.perf_counter() - t_start
    while n > MIN_N and elapsed + FULL_S_PER_ROW * n > TIME_LIMIT_S - MARGIN_S:
        cuts.append(f"N {n} -> {max(MIN_N, n // 2)} for the time limit")
        n = max(MIN_N, n // 2)

    t0 = time.perf_counter()
    full, e, ds = full_phase(dev, n)
    full["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    serve, index = serve_phase(e, ds, dev)
    serve["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve", **serve})

    t0 = time.perf_counter()
    opsr = ops_phase(e, ds)
    opsr["seconds"] = time.perf_counter() - t0
    emit({"phase": "ops", **opsr})

    # phase 9 runs here, on the engine as phase 4 built it: phase 7's
    # inserts grow the stores past 2**20 rows, where the visited set hashes
    t0 = time.perf_counter()
    oracles = oracle_phase(e, ds, dev, full["reachable_from_medoid"])
    oracles["seconds"] = time.perf_counter() - t0
    emit({"phase": "oracles", "seconds": oracles["seconds"],
          "launches": oracles["launches"]})

    # phase 11 runs before phase 10, whose build cut reads the clock, on
    # the phase-5 Index as phase 4 built its engine
    t0 = time.perf_counter()
    lmr = lm_phase(dev, index, ds)
    lmr["seconds"] = time.perf_counter() - t0
    emit({"phase": "lm", "seconds": lmr["seconds"],
          "launches": lmr["launches"]})

    # phase 12 too runs before phase 10
    t0 = time.perf_counter()
    trn = train_phase(dev)
    trn["seconds"] = time.perf_counter() - t0
    emit({"phase": "train", "seconds": trn["seconds"],
          "launches": trn["launches"]})

    # phase 13 too runs before phase 10
    t0 = time.perf_counter()
    meshr = mesh_phase(dev)
    meshr["seconds"] = time.perf_counter() - t0
    emit({"phase": "mesh", "seconds": meshr["seconds"],
          "launches": meshr["launches"]})

    # phase 10 too runs on the engine as phase 4 built it
    t0 = time.perf_counter()
    shard = shard_phase(e, ds, dev, full, t_start)
    shard["seconds"] = time.perf_counter() - t0
    emit({"phase": "shard", "seconds": shard["seconds"],
          "entry_calls": shard["entry_calls"],
          "launches": shard["launches"]})

    t0 = time.perf_counter()
    life = lifecycle_phase(index, ds, dev)
    life["seconds"] = time.perf_counter() - t0
    emit({"phase": "lifecycle", **life})

    t0 = time.perf_counter()
    disk = disk_phase(index, ds, dev)
    disk["seconds"] = time.perf_counter() - t0
    emit({"phase": "disk", **{k: v for k, v in disk.items()
                              if k not in ("runs", "cold")}})

    launches = {"full": full["launches"], "serve": serve["launches"],
                "ops": opsr["launches"], "disk": disk["launches"],
                "oracles": oracles["launches"], "shard": shard["launches"],
                "lm": lmr["launches"], "train": trn["launches"],
                "mesh": meshr["launches"], "wide": wide["launches"]}
    rows = []
    for name, (key, source, replaces) in KERNELS.items():
        count = launches[LAUNCH_PHASE[name]][name]
        assert count > 0, f"{name} was not launched on the main path"
        r = kern["results"][key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": count,
                     "launches_by_phase": {p: c[name]
                                           for p, c in launches.items()},
                     "shape": r["shape"], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "kernel_ms": r["ms"],
                     "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms")})
        rows[-1]["beside"] = {
            b: {x: kern["results"][b].get(x)
                for x in ("shape", "ms", "plain_ms", "bound_ms", "kept")}
            for b in BESIDE.get(name, ())}
    emit({"kernels": rows, "n_full": full["n"], "n_cuts": cuts,
          "launch_floor_ms": kern["results"]["launch_floor"]["ms"],
          "launch_floor_approx_probe_ms":
              kern["results"]["launch_floor/approx_probe"]["ms"],
          "full_phase_s": full["seconds"], "serve_phase_s": serve["seconds"],
          "ops_phase_s": opsr["seconds"], "lifecycle_phase_s": life["seconds"],
          "disk_phase_s": disk["seconds"],
          "oracle_phase_s": oracles["seconds"],
          "shard_phase_s": shard["seconds"], "lm_phase_s": lmr["seconds"],
          "train_phase_s": trn["seconds"], "mesh_phase_s": meshr["seconds"],
          "wide_phase_s": wide["seconds"],
          "wide_hop_fused_launches_per_hop_step":
              wide["in"]["hop_fused_launches_per_hop_step"],
          "shard_build_cut": shard["build"]["cut"],
          "oracle_pq_scan_launches_per_hop_step":
              oracles["distance_fn"]["pq_scan_launches_per_hop_step"],
          "disk_entry_calls": {k: disk["entry_calls"].get(k, 0)
                               for k in ("hop_fused_gather", "or_scatter_",
                                         "pq_scan_gather")},
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

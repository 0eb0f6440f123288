"""Dry-run of the paper's distributed filtered-search step at LAION100M
scale on the production mesh. Counterpart of ``repro.launch.dryrun_ann``,
which compiles the step for 512 fake TPU devices.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_ann \\
      [--mesh single|multi|both] [--out experiments/dryrun_torch]

* Tiers, from the shapes: the record store (the "SSD" tier: vectors,
  adjacency, 2-hop lists, labels, values) shards over every mesh axis; PQ
  codes, Bloom words and bucket codes (the "DRAM" tier) replicate. The
  JSON gives each tier's bytes on a card.
* One hop: ``core.distributed.distributed_filtered_search`` runs at these
  widths (DIM, R, R_DENSE, PQ_M, labels, BATCH, L) on a small random store
  on the CPU under ``roofline.count_step``, with ``max_hops`` 1 and 2; the
  difference is one hop, scaled to MAX_HOPS (the bound of the JAX step's
  loop). Queries are replicated, as in ``repro``: every card runs the
  whole batch's hop, so the count is a card's. (The hop loop reads its
  active mask to the host, so it cannot run on ``meta``.)
* The collective: each hop's fetch hands every card the frontier's
  records, ``repro``'s masked local gather + psum over all mesh axes: an
  all-reduce of BATCH × beam width records.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import search as S
from repro_torch.core import selectors as SEL
from repro_torch.core.pq import PQCodebook
from repro_torch.core.records import RecordStore, candidate_first_mask
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, \
    shard_plan

# LAION100M-scale parameters (paper §5.1)
N = 100_000_000
DIM = 192
R = 96
R_DENSE = 1100
PQ_M = 32
MAX_LABELS = 16
QL, CAP = 8, 4096
NF = 2                     # numeric attribute fields (schema nums)
NR = 4                     # range-predicate slots per query (IndexConfig.qr)
BATCH = int(os.environ.get("REPRO_ANN_BATCH", "64"))  # coalesced queries
L_SEARCH = 128
MAX_HOPS = 192
N_SMALL = 4096             # rows of the store the hop is counted on
N_LABELS = 1000


def tier_bytes(n_shards: int) -> dict:
    """Bytes of each tier on one card: the record store's fields over
    ``n_shards`` (N padded to a multiple), the in-memory tier whole."""
    n = -(-N // n_shards) * n_shards
    per = n // n_shards
    return {
        "sharded": {"vectors": per * DIM * 4, "neighbors": per * R * 4,
                    "dense_neighbors": per * R_DENSE * 4,
                    "rec_labels": per * MAX_LABELS * 4,
                    "rec_values": per * NF * 4},
        "replicated": {"pq_codes": n * PQ_M, "blooms": n * 4,
                       "bucket_codes": n * NF},
    }


def record_bytes() -> int:
    """One record as the fetch's psum carries it: every field, the
    ``cand_first`` bits counted in int32 (as ``repro`` psums them)."""
    return 4 * (DIM + R + R_DENSE + MAX_LABELS + NF) + 4 * (R + R_DENSE)


def small_problem(seed: int = 0):
    """A random store, codes, codebook, in-memory tier and label-OR
    filters at the step's widths, N_SMALL rows, on the CPU."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    nbrs = t(rng.integers(0, N_SMALL, (N_SMALL, R), dtype=np.int32))
    dense = t(rng.integers(0, N_SMALL, (N_SMALL, R_DENSE), dtype=np.int32))
    store = RecordStore(
        vectors=t(rng.normal(size=(N_SMALL, DIM)).astype(np.float32)),
        neighbors=nbrs, dense_neighbors=dense,
        rec_labels=t(rng.integers(0, N_LABELS, (N_SMALL, MAX_LABELS),
                                  dtype=np.int32)),
        rec_values=t(rng.random((N_SMALL, NF), dtype=np.float32)),
        pages_std=1, pages_dense=2,
        cand_first=candidate_first_mask(nbrs, dense))
    codes = t(rng.integers(0, 256, (N_SMALL, PQ_M), dtype=np.uint8))
    codebook = PQCodebook(centroids=t(rng.normal(
        size=(PQ_M, 256, DIM // PQ_M)).astype(np.float32)), dim=DIM)
    mem = SEL.InMemory(
        blooms=t(rng.integers(-2**31, 2**31, N_SMALL, dtype=np.int64)
                 .astype(np.int32)),
        bucket_codes=t(rng.integers(0, 256, (N_SMALL, NF), dtype=np.uint8)))
    filters = []
    for _ in range(BATCH):
        f = SEL.always_true_filter(QL, CAP, NR)._asdict()
        labels = np.full(QL, -1, np.int32)
        labels[:2] = rng.integers(0, N_LABELS, 2)
        f.update(q_labels=labels, label_mode=np.int32(SEL.L_OR),
                 bloom_or_masks=np.array(
                     [1 << int(rng.integers(32)), 1 << int(rng.integers(32))]
                     + [0] * (QL - 2), np.uint32))
        filters.append(SEL.QueryFilter(**f))
    qf = SEL.filter_to_device(SEL.stack_filters(filters), "cpu")
    queries = t(rng.normal(size=(BATCH, DIM)).astype(np.float32))
    return store, codes, codebook, mem, qf, queries


def count_hop() -> dict:
    """The counts of one hop (``max_hops`` 2 less 1) and of the rest (the
    seeding, the first fetch, the finalize), on a one-shard plan: one
    card's share of the replicated-query step."""
    store, codes, codebook, mem, qf, queries = small_problem()
    plan = shard_plan(make_local_mesh(1, 1, "cpu"))

    def run(hops):
        params = S.SearchParams(l_search=L_SEARCH, k=10, max_hops=hops,
                                mode="spec_in")
        with torch.no_grad():
            return roofline.count_step(D.distributed_filtered_search, plan,
                                       store, codes, codebook, mem, qf,
                                       queries, 0, params)

    one, two = run(1), run(2)
    hop = {k: two[k] - one[k] for k in one}
    return {"hop": hop, "rest": {k: one[k] - hop[k] for k in one}}


def run(mesh_kind: str, out_dir: str = OUT_DIR, counts=None) -> dict:
    """One mesh's dry-run. ``counts`` (from :func:`count_hop`) is counted
    here when not given: it does not depend on the mesh."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="meta")
    n_chips = mesh.size
    result = {"arch": "pipeann-filter-100m", "shape": f"search_b{BATCH}",
              "mesh": mesh_kind, "kind": "ann_search", "status": "error",
              "n_chips": n_chips}
    t0 = time.perf_counter()
    try:
        plan = shard_plan(mesh)
        tiers = tier_bytes(plan.n_shards)
        counts = counts or count_hop()
        hop, rest = counts["hop"], counts["rest"]
        flops = MAX_HOPS * hop["flops"] + rest["flops"]
        hbm = MAX_HOPS * hop["bytes"] + rest["bytes"]
        axis = "+".join(mesh.axis_names)
        coll = {"all-reduce": {axis: MAX_HOPS * roofline._payload(
            BATCH * record_bytes(), n_chips)}}
        coll_w = roofline.weighted_collective_bytes(roofline.by_op(coll))
        terms = roofline.roofline_terms(
            flops, hbm, coll_w,
            collective_s=roofline.collective_seconds(coll, mesh),
            peak_flops=roofline.F32_FLOPS)
        args = sum(tiers["sharded"].values()) + \
            sum(tiers["replicated"].values())
        result.update({
            "status": "ok",
            "trace_s": round(time.perf_counter() - t0, 1),
            "n_shards": plan.n_shards,
            "tiers": tiers,
            "memory": {"argument_bytes": args, "output_bytes": 0,
                       "temp_bytes": 0, "peak_estimate_bytes": args},
            "counted": {"hop": hop, "rest": rest, "max_hops": MAX_HOPS,
                        "store_rows_counted": N_SMALL,
                        "flops_per_chip": flops, "bytes_per_chip": hbm,
                        "record_bytes": record_bytes(),
                        "collective_bytes": roofline.by_op(coll),
                        "collective_bytes_by_axis": coll,
                        "collective_bytes_weighted": coll_w},
            "roofline": terms,
        })
    except Exception as e:                                 # noqa: BLE001
        result.update({"error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"ann_search_{mesh_kind}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    counts, results = None, []
    for mk in (["single", "multi"] if args.mesh == "both" else [args.mesh]):
        r = run(mk, args.out, counts)
        counts = r.get("counted") and {"hop": r["counted"]["hop"],
                                       "rest": r["counted"]["rest"]}
        results.append(r)
        if r["status"] == "ok":
            extra = (f" peak={r['memory']['peak_estimate_bytes']/2**30:.2f}"
                     f"GiB dom={r['roofline']['bottleneck']}")
        else:
            extra = " " + r.get("error", "")[:150]
        print(f"[ann-search × {mk}] {r['status']}"
              f" ({r.get('trace_s', 0)}s){extra}", flush=True)
    return results


if __name__ == "__main__":
    main()

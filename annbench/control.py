"""The control of the comparison that decides ``correct``.

The plain reference, computed in bfloat16 (the nearest precision below the
configuration's float32), is put in the program's place: its top-k ids and
its own distances are the answers, judged by ``judge.py`` against the
float32 reference exactly as a run's answers are. The control has to come
out not correct.

    python3 annbench/control.py --workload <cell> --seeds 1 2 3

Each seed makes the cell's corpus and query pool at the cell's own size and
answers the requests its clients would send first, as many as ``--requests``
(default: as many as the pool holds). It prints one JSON line a seed with
the numbers, the limits and the verdict. It needs no index, so it runs in
seconds on the card; ``--device cpu`` runs it on the CPU.

    python3 annbench/control.py --workload <cell> --seeds 1 2 3 \
        --max-hops 8 --seconds 20

plants a fault in the program instead: its hop loop stops after
``--max-hops`` hops (the cell's configuration otherwise), and each seed is
a whole run of the cell (build, warm-up, a window of ``--seconds``, the
check), whose numbers are printed the same way. That is the reading which
sets the upper end of ``recall_shortfall``'s limit in the cells whose
queries walk the graph.

    python3 annbench/control.py --workload <cell> --seeds 1 2 3 \
        --l-rerank-delta -54 --seconds 20

plants the fault that the ``pre`` route feels, which no hop budget
touches: its re-rank pool (the route's pool length plus
``l_rerank_delta``, the records it re-ranks exactly after the PQ scan of
the filter's posting) is cut. At L 32 a one-tag filter's pool is 64, so
-54 leaves 10: the route's answer is the PQ scan's own top-10.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(files: dict, seed: int, requests: int, device,
                    dtype=None) -> dict:
    import numpy as np
    import torch

    from annbench import judge, loadgen
    from annbench.corpus import make_corpus
    from annbench.reference import Reference
    config, traffic = files["config"], files["traffic"]
    dtype = dtype or torch.bfloat16
    corpus = make_corpus(config["corpus"], seed, int(traffic["pool"]))
    pool = loadgen.make_pool(traffic, corpus, seed)
    clients = int(traffic["clients"])
    streams = loadgen.ClientStreams(clients, len(pool))
    rows = [streams.next(i % clients) for i in range(requests)]
    k = int(traffic["request"]["k"])
    width = config["index"]["max_labels"]
    low = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, width, device, dtype=dtype)
    used = sorted(set(rows))
    ids = np.full((len(pool), k), -1, np.int64)
    dists = np.full((len(pool), k), np.inf, np.float64)
    ids[used], dists[used] = low.search(pool.vectors[used], pool.tags[used],
                                        pool.ranges[used], k)
    del low
    ref = Reference(corpus.vectors, corpus.tag_offsets, corpus.tag_flat,
                    corpus.numerics, width, device)
    exact = np.full((len(pool), k), -1, np.int64)
    exact[used] = ref.search(pool.vectors[used], pool.tags[used],
                             pool.ranges[used], k)[0]
    answers = [(r, ids[r][ids[r] >= 0], dists[r][ids[r] >= 0])
               for r in rows]
    return judge.compare(answers, 0, pool.vectors, pool.tags, pool.ranges,
                         exact, ref)


def fault_checks(files: dict, cell: str, seed: int, seconds: float,
                 search: dict, device) -> dict:
    """A whole run of the cell with the program's ``SearchConfig`` fields
    ``search`` set (the fault): its result, ``checks`` last."""
    import copy

    from annbench import harness
    files = copy.deepcopy(files)
    files["config"]["search"].update(search)
    return harness.run_cell(cell, seed, seconds, False, device, ROOT,
                            time.perf_counter(), files=files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--max-hops", type=int, default=0,
                    help="run the program with its hop loop cut to this "
                    "many hops instead of the control")
    ap.add_argument("--l-rerank-delta", type=int, default=None,
                    help="run the program with the pre route's re-rank "
                    "pool cut by this l_rerank_delta instead of the control")
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="the window of a run with a fault")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from annbench import harness, judge
    files = harness.cell_files(harness.load_bench(ROOT), args.workload, ROOT)
    n = args.requests or int(files["traffic"]["pool"])
    fault = {}
    if args.max_hops:
        fault["max_hops"] = args.max_hops
    if args.l_rerank_delta is not None:
        fault["l_rerank_delta"] = args.l_rerank_delta
    for seed in args.seeds:
        t0 = time.perf_counter()
        if fault:
            res = fault_checks(files, args.workload, seed, args.seconds,
                               fault, args.device)
            correct, checks, n = (res["correct"], res["checks"],
                                  res["attempted"])
        else:
            numbers = control_numbers(files, seed, n, args.device)
            correct, checks = judge.verdict(numbers, files["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": fault or None,
                          "requests": n, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` from several checkouts on one card,
one fresh process each, and compare them.

    python3 tools/ab_full_phase.py --n 1000000 OLD . . OLD
    python3 tools/ab_full_phase.py --phase kernels OLD . . OLD

Each argument is the root of a checkout that holds ``chip_smoke.py`` and
``src/repro_torch``. The checkouts run one after another in the order given,
so ``OLD NEW NEW OLD`` sees each in both halves of the call. Each process
imports its checkout's ``chip_smoke`` and calls one phase:

* ``--phase full`` (the default): ``full_phase``, the index build, the
  hop-loop profile and the ``engine.search`` runs;
* ``--phase kernels``: ``kernel_phase``, each kernel built from that
  checkout's sources and timed against its plain version.

Every JSON line a process prints is echoed with the checkout and the run's
position; at the end come the card's name and power limit as
``nvidia-smi`` prints them and one ``ab_summary`` line, per run: for the
full phase build seconds and stages, ms per hop and each search run's QPS
and batch p50; for the kernel phase every row's device ms, the cold-L2 rows
(``pq_scan/scan_cold``, ``approx_probe/1M_cold``) and both launch floors
included. A checkout whose kernel phase lacks a row (an older one) shows
only the rows it has.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke
dev = torch.device("cuda", 0)
torch.cuda.init()
torch.cuda.get_device_name(dev)
if sys.argv[3] == "kernels":
    print(json.dumps({"phase": "kernels_vs_plain",
                      **chip_smoke.kernel_phase(dev)}), flush=True)
else:
    chip_smoke.full_phase(dev, int(sys.argv[2]))
"""


def run_one(root: Path, n: int, pos: int, phase: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root), str(n),
                           phase],
                          cwd=root, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"{root}: {phase} phase exited {proc.returncode}")
    row = {"checkout": str(root), "pos": pos, "searches": {}}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        print(json.dumps({"checkout": str(root), "pos": pos, **obj}),
              flush=True)
        phase = obj.get("phase")
        if phase == "kernels_vs_plain":
            row["build_s"] = obj["build_s"]
            row["kernel_ms"] = {name: r["ms"]
                                for name, r in obj["results"].items()}
        elif phase == "full_build":
            row["build_s"] = obj["build_s"]
            row["build_stages_s"] = obj["build_stages_s"]
        elif phase == "hop_loop":
            row["ms_per_hop"] = obj["ms_per_hop"]
            row["torch_ops_per_hop"] = obj["torch_ops_per_hop"]
        elif phase == "full_search":
            row["searches"][obj["run"]] = {
                "qps": obj["qps"], "p50_batch_ms": obj["p50_batch_ms"],
                "recall_at_10": obj["recall_at_10"]}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size of the full phase")
    ap.add_argument("--phase", choices=("full", "kernels"), default="full")
    ap.add_argument("roots", nargs="+", type=Path)
    args = ap.parse_args(argv)
    rows = [run_one(r.resolve(), args.n, i, args.phase)
            for i, r in enumerate(args.roots)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ab_summary": rows, "phase": args.phase,
                      "n": args.n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark and print its result as the last line.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json``. The run
needs a CUDA card (it exits 2 without one, printing no result), builds the
program's kernels into the checkout's ``build/`` (once: later runs reuse
them), writes the disk tier's slab files under ``TMPDIR`` and deletes them,
and exits 3 without a result if the process holds JAX or the JAX package
once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from annbench import harness

    bench = harness.load_bench(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", ROOT, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run's process holds {', '.join(found)}: the benchmark "
              "may load none of them", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

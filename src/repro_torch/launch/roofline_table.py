"""Tables of the port's dry-run JSON (``launch.dryrun``,
``launch.dryrun_ann``): the roofline of the single-pod cells and the
dry-run summary of both meshes. Counterpart of
``repro.launch.roofline_table``; every time in them is analytic, at the
H100 SXM data sheet's rates (``launch.roofline``), not measured.

  PYTHONPATH=src python -m repro_torch.launch.roofline_table \\
      [--dir experiments/dryrun_torch] [--what roofline|dryrun|both|summary]

``summary`` folds both into one row per arch.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR

ARCH_ORDER = ["mixtral-8x22b", "arctic-480b", "qwen2-1.5b", "qwen2-7b",
              "deepseek-7b", "starcoder2-7b", "musicgen-medium",
              "jamba-v0.1-52b", "internvl2-2b", "mamba2-2.7b",
              "pipeann-filter-100m"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "search_b64"]


def load(dir_: str) -> list:
    rows = []
    for fn in glob.glob(os.path.join(dir_, "*.json")):
        with open(fn) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (ARCH_ORDER.index(r["arch"])
                             if r["arch"] in ARCH_ORDER else 99,
                             SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 99,
                             r["mesh"]))
    return rows


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(rows: list, mesh: str = "single") -> str:
    out = ["| arch | shape | compute | memory | collective | bottleneck | "
           "roofline frac | useful/counted flops | peak GiB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped (full attention) | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        t = r["roofline"]
        peak = r["memory"]["peak_estimate_bytes"] / 2**30
        ratio = r.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"{t['bottleneck'].replace('_s','')} | "
            f"{t['roofline_fraction']:.3f} | "
            f"{'—' if ratio is None else f'{ratio:.2f}'} | {peak:.1f} |")
    return "\n".join(out)


def dryrun_table(rows: list) -> str:
    out = ["| arch | shape | mesh | status | peak GiB | counted flops/chip | "
           "coll bytes/chip | collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"skipped | — | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR "
                       f"| | | | {r.get('error','')[:60]} |")
            continue
        peak = r["memory"]["peak_estimate_bytes"] / 2**30
        fl = r["counted"]["flops_per_chip"]
        cb = r["counted"]["collective_bytes_weighted"]
        kinds = "+".join(sorted(r["counted"]["collective_bytes"]))
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                   f"{peak:.1f} | {fl:.2e} | {cb:.2e} | {kinds} |")
    return "\n".join(out)


def summary_table(rows: list) -> str:
    """One row per arch, one column per shape: each cell the single pod's
    bound (the largest roofline term) and its term, then the peak
    estimate in GiB on the single and the multi-pod mesh."""
    by = {}
    for r in rows:
        by.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
    shapes = [s for s in SHAPE_ORDER if any(s in v for v in by.values())]
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]

    def cell(meshes):
        one = meshes.get("single")
        if one is None or one["status"] != "ok":
            return one["status"] if one else "—"
        t = one["roofline"]
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        peaks = "/".join(
            f"{meshes[m]['memory']['peak_estimate_bytes'] / 2**30:.1f}"
            if meshes.get(m, {}).get("status") == "ok" else "—"
            for m in ("single", "multi"))
        return f"{fmt_s(bound)} {t['bottleneck'][:-2]} · {peaks}"

    for arch, cells in by.items():
        out.append(f"| {arch} | " + " | ".join(
            cell(cells[s]) if s in cells else "" for s in shapes) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--what", default="both",
                    choices=["roofline", "dryrun", "both", "summary"])
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.what == "summary":
        print(summary_table(rows))
        return
    if args.what in ("roofline", "both"):
        print("## Roofline (single-pod, 256 H100s; analytic)\n")
        print(roofline_table(rows, "single"))
        print()
    if args.what in ("dryrun", "both"):
        print("## Dry-run (both meshes)\n")
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()

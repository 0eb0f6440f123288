"""Multi-pod dry-run: every (architecture × input shape) cell on the
production mesh, counted on ``meta`` tensors against an analytic H100
roofline; memory, FLOPs, bytes and collectives go to
``experiments/dryrun_torch/*.json``. Counterpart of ``repro.launch.dryrun``,
which lowers and compiles each cell for 512 fake TPU devices.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k --mesh single [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Runs on any host: the mesh, the parameters (``lm.init_lm(cfg, 0,
"meta")``), the inputs (``configs.input_specs``) and every step run on
``meta``. Per cell:

* the specs of ``launch.shardings`` (FSDP on, as the JAX dry-run) on the
  parameters, optimizer state, inputs and caches, and the per-card bytes
  they give (``sharded_bytes``);
* the step (``train_loop.make_train_step`` with the JAX dry-run's
  microbatches and accumulator dtype, ``lm_prefill`` or
  ``lm_decode_step``) counted by ``roofline.count_step``. Layers of a
  segment are alike, so the step is counted at one and at two repeats of
  each segment and extrapolated linearly to the config's depth (as the
  JAX analysis weights a scanned layer by its trip count);
* per-card FLOPs and bytes: the counts over the cards (the work split
  evenly); collectives from the specs (``roofline.collective_bytes``);
  the roofline terms at the H100 SXM data sheet's rates;
* ``peak_estimate_bytes``, an estimate: the sharded arguments, the
  outputs that do not update an argument in place, and the temporaries
  (train: the gradient accumulator, sharded as the parameters, and the
  activations autograd saves for one microbatch's backward, divided by
  the DP shards).

``REPRO_SP_DECODE=1`` runs decode cells split-K (``cfg.sp_decode``), as in
the JAX dry-run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import (SHAPES, get_config, input_specs,
                                 list_archs, runnable)
from repro_torch.launch import roofline, shardings
from repro_torch.launch.mesh import dp_axes, dp_size, make_production_mesh
from repro_torch.models import convert, lm
from repro_torch.models.common import (ModelConfig, cdtype,
                                       clear_activation_sharding,
                                       set_activation_sharding)
from repro_torch.train import optim, train_loop
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

OUT_DIR = os.path.join("experiments", "dryrun_torch")
# archs whose training state needs int8 moments + FSDP to fit 16 GB/chip
BIG_TRAIN = {"arctic-480b", "mixtral-8x22b", "jamba-v0.1-52b"}
# the JAX dry-run gives MoE archs batch-only sharding with more
# microbatches (sequence parallelism conflicts with the MoE token reshape
# in XLA's backward)
MOE_ARCHS = {"arctic-480b", "mixtral-8x22b", "jamba-v0.1-52b"}


def build_cfg(arch: str, kind: str) -> ModelConfig:
    cfg = get_config(arch)
    if kind == "train":
        # bf16 params + int8 moments for the biggest configs
        if arch in BIG_TRAIN:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        return cfg
    # serving: bf16 weights, no remat
    return dataclasses.replace(cfg, param_dtype="bfloat16", remat=False)


def _depth(cfg: ModelConfig, repeats) -> ModelConfig:
    segs = tuple((r, p) for r, (_, p) in zip(repeats, cfg.segments))
    return dataclasses.replace(cfg, segments=segs,
                               n_layers=sum(r * len(p) for r, p in segs))


def linear_count(cfg: ModelConfig, run) -> dict:
    """``run(cfg')``'s counts at ``cfg``'s depth: counted with every
    segment at one repeat, then each segment at two, and each segment's
    per-repeat difference scaled to its repeats."""
    base = [1] * len(cfg.segments)
    c0 = run(_depth(cfg, base))
    total = dict(c0)
    for i, (r, _) in enumerate(cfg.segments):
        if r > 1:
            c1 = run(_depth(cfg, base[:i] + [2] + base[i + 1:]))
            for k in total:
                total[k] += (r - 1) * (c1[k] - c0[k])
    return total


def _counted(counts, key, cfg: ModelConfig, run) -> dict:
    """:func:`linear_count`, kept in ``counts`` (a dict, or None) under
    ``key``: a cell counts the same step on either mesh."""
    if counts is None:
        return linear_count(cfg, run)
    if key not in counts:
        counts[key] = linear_count(cfg, run)
    return dict(counts[key])


def _active_params(cfg: ModelConfig, n_params: int, ptree: dict) -> int:
    """Active params per token (MoE: only top-k experts count), from the
    parameter tree of :func:`param_tree`."""
    if cfg.moe is None:
        return n_params
    expert_total = 0
    for ks, leaf in tree_flatten_with_path(ptree):
        if any(t in ks for t in (".w_gate", ".w_up", ".w_down")) \
                and "moe" in ks:
            expert_total += int(np.prod(leaf.shape))
    return n_params - expert_total \
        + expert_total * cfg.moe.top_k // cfg.moe.n_experts


def _train(arch, shape, mesh, rules, cfg, counts):
    """Specs, argument bytes and the counted step of a train cell."""
    micro = 8 if arch in MOE_ARCHS else 4
    acc_dt = torch.bfloat16 if arch in BIG_TRAIN else torch.float32
    ocfg = optim.OptConfig(int8_moments=arch in BIG_TRAIN)
    model = lm.init_lm(cfg, 0, "meta")
    ptree = convert.param_shapes(cfg, model)
    pspec = shardings.param_specs(rules, ptree)
    opt = optim.init_opt_state(model, ocfg)
    otree = optim.OptState(step=opt.step,
                           m=convert.to_repro_tree(cfg, opt.m),
                           v=convert.to_repro_tree(cfg, opt.v))
    ospec = shardings.opt_specs(rules, otree, ptree)
    inputs = input_specs(cfg, shape)
    dspec = shardings.data_specs(rules, inputs, shape.global_batch)
    args = (shardings.sharded_bytes(ptree, pspec, mesh)
            + shardings.sharded_bytes(otree, ospec, mesh)
            + shardings.sharded_bytes(inputs, dspec, mesh))
    acc = shardings.sharded_bytes(
        tree_map(lambda x: torch.empty(x.shape, dtype=acc_dt,
                                       device="meta"), ptree), pspec, mesh)

    def run(c):
        m = lm.init_lm(c, 0, "meta")
        spec = shardings.param_specs(rules, convert.param_shapes(c, m))
        step = train_loop.make_train_step(c, ocfg, microbatches=micro,
                                          mesh=mesh, param_specs=spec,
                                          acc_dtype=acc_dt)
        return roofline.count_step(step, m, optim.init_opt_state(m, ocfg),
                                   inputs)

    counted = _counted(counts, (arch, shape.name), cfg, run)
    mem = {"argument_bytes": args, "output_bytes": 0,
           "temp_bytes": acc + counted["saved_bytes"] / micro
           / dp_size(mesh)}
    return ptree, pspec, [], [], mem, counted, \
        {"microbatches": micro, "acc_bytes": acc_dt.itemsize}


def _serve(shape, mesh, rules, cfg, counts):
    """Specs, argument bytes and the counted step of a prefill or decode
    cell."""
    b, t = shape.global_batch, shape.seq_len
    model = lm.init_lm(cfg, 0, "meta")
    ptree = convert.param_shapes(cfg, model)
    pspec = shardings.param_specs(rules, ptree)
    caches = convert.caches_to_repro_tree(
        cfg, lm.init_caches(cfg, b, t, device="meta"))
    cspec = [shardings.cache_specs(rules, c, b) for c in caches]
    inputs = input_specs(cfg, shape)
    dspec = shardings.data_specs(rules, inputs, b)
    pbytes = shardings.sharded_bytes(ptree, pspec, mesh)
    cbytes = sum(shardings.sharded_bytes(c, s, mesh)
                 for c, s in zip(caches, cspec))
    in_bytes = shardings.sharded_bytes(inputs, dspec, mesh)
    b_div = dp_size(mesh) if rules.ax(b, rules.dp) else 1
    logits = b * cfg.vocab * cdtype(cfg).itemsize // b_div
    if shape.kind == "prefill":
        mem = {"argument_bytes": pbytes + in_bytes,
               "output_bytes": logits + cbytes, "temp_bytes": 0}

        def run(c):
            m = lm.init_lm(c, 0, "meta")
            with torch.no_grad():
                return roofline.count_step(lm.lm_prefill, m, c, inputs, t)
    else:
        mem = {"argument_bytes": pbytes + cbytes + in_bytes,
               "output_bytes": logits, "temp_bytes": 0}

        def run(c):
            m = lm.init_lm(c, 0, "meta")
            cs = lm.init_caches(c, b, t, device="meta")
            with torch.no_grad():
                return roofline.count_step(lm.lm_decode_step, m, cs, c,
                                           inputs["tokens"])
    counted = _counted(counts, (cfg.name, shape.name, cfg.sp_decode), cfg,
                       run)
    return ptree, pspec, caches, cspec, mem, counted, \
        {"sp_decode": cfg.sp_decode}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = OUT_DIR, counts=None) -> dict:
    """One cell's dry-run, dumped as JSON under ``out_dir`` and returned.
    ``counts`` (a dict) keeps the counted step for the cell on the other
    mesh."""
    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "kind": shape.kind, "status": "skipped"}
    if not runnable(cfg0, shape):
        result["reason"] = "full-attention arch: long_500k not sub-quadratic"
        _dump(result, out_dir)
        return result

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="meta")
    n_chips = mesh.size
    rules = shardings.Rules(mesh=mesh, fsdp=True)
    dp_div = shape.global_batch % dp_size(mesh) == 0
    t0 = time.perf_counter()
    try:
        if shape.kind == "train":
            cfg = build_cfg(arch, "train")
            set_activation_sharding(
                mesh, dp_axes(mesh),
                seq_axis=None if arch in MOE_ARCHS else "model")
            ptree, pspec, caches, cspec, mem, counted, step = _train(
                arch, shape, mesh, rules, cfg, counts)
        else:
            cfg = build_cfg(arch, "serve")
            if shape.kind == "decode" and os.environ.get("REPRO_SP_DECODE"):
                cfg = dataclasses.replace(cfg, sp_decode=True)
                set_activation_sharding(mesh, dp_axes(mesh))
            elif dp_div:
                set_activation_sharding(mesh, dp_axes(mesh))
            ptree, pspec, caches, cspec, mem, counted, step = _serve(
                shape, mesh, rules, cfg, counts)
        trace_s = time.perf_counter() - t0
        step.update(batch=shape.global_batch, seq=shape.seq_len,
                    act_bytes=cdtype(cfg).itemsize, n_heads=cfg.n_heads,
                    head_dim=cfg.head_dim)
        coll = roofline.collective_bytes(
            rules, {"params": pspec, "caches": cspec},
            {"params": ptree, "caches": caches}, shape.kind, step)
        coll_w = roofline.weighted_collective_bytes(roofline.by_op(coll))
        coll_s = roofline.collective_seconds(coll, mesh)
        flops = counted["flops"] / n_chips
        hbm = counted["bytes"] / n_chips
        terms = roofline.roofline_terms(flops, hbm, coll_w,
                                        collective_s=coll_s)

        n_params = lm.param_count(cfg)
        n_active = _active_params(cfg, n_params, ptree)
        mflops = roofline.model_flops(cfg, n_params, n_active, shape)
        mem["peak_estimate_bytes"] = (mem["argument_bytes"]
                                      + mem["output_bytes"]
                                      + mem["temp_bytes"])
        result.update({
            "status": "ok",
            "n_chips": n_chips,
            "n_params": n_params,
            "n_active_params": n_active,
            "trace_s": round(trace_s, 1),
            "memory": mem,
            "counted": {
                "flops_global": counted["flops"],
                "flops_per_chip": flops,
                "bytes_global": counted["bytes"],
                "bytes_per_chip": hbm,
                "aten_ops": counted["ops"],
                "saved_bytes_global": counted["saved_bytes"],
                "collective_bytes": roofline.by_op(coll),
                "collective_bytes_by_axis": coll,
                "collective_bytes_weighted": coll_w,
                "sp_decode": cfg.sp_decode,
            },
            "model_flops_global": mflops,
            "model_flops_per_chip": mflops / n_chips,
            "useful_flops_ratio": (mflops / n_chips) / flops
            if flops else 0.0,
            "roofline": terms,
        })
    except Exception as e:                                 # noqa: BLE001
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    finally:
        clear_activation_sharding()
    _dump(result, out_dir)
    return result


def _dump(result: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results, counts = [], {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                r = run_cell(arch, shape, mesh_kind, args.out, counts)
                results.append(r)
                status = r["status"]
                extra = ""
                if status == "ok":
                    peak = r["memory"]["peak_estimate_bytes"] / 2**30
                    extra = (f" peak={peak:.2f}GiB "
                             f"dom={r['roofline']['bottleneck']}")
                elif status == "error":
                    extra = " " + r["error"][:120]
                print(f"[{arch} × {shape} × {mesh_kind}] {status}"
                      f" ({time.time()-t0:.0f}s){extra}", flush=True)
    return results


if __name__ == "__main__":
    main()

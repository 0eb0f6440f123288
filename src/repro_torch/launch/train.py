"""Training launcher: fault-tolerant step loop with retry, checkpoint and
restart, straggler watchdog. Counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 100 --smoke --device cpu --ckpt-dir ckpt

Runs on the card unless ``--device cpu`` is given. ``--mesh local`` lays
a (1, device count) mesh over the one device the port trains on
(``launch.mesh.make_local_mesh``), with ``launch.shardings.Rules(fsdp=not
--smoke)``: the parameter specs are checked against the parameters and
give the bytes each device of that layout would hold. ``--mesh single``
and ``multi`` ask for the production mesh (16 × 16, or 2 × 16 × 16), which
needs as many distinct cards and raises with both counts otherwise, as
the JAX launcher does.

A failing step restores the latest checkpoint and retries, up to
``--max-retries``; ``--fail-at-step K`` makes step K fail once, before its
update, to drill that path. Checkpoints hold the JAX launcher's tree
(``train.train_loop.train_state_tree``), saved after step K as ``step_K``.
A restore resumes at the optimizer's step count, the step after the saved
one, so a resumed run takes each batch once (the JAX launcher resumes at
the saved step and takes that batch twice).

``main`` returns its numbers: the loss of each step, step seconds (host
clock, the device synchronised by reading the loss) and their median from
the second step on, tokens/s, parameters, the step's bound (8 · params ·
tokens FLOPs over the H100's dense bfloat16 rate, ``launch.roofline``),
the mesh and its per-device parameter bytes, and on the card its peak
memory. :func:`count_step_ops` counts a step's PyTorch calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import torch

from repro_torch.ckpt import ArraySpec, CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import Prefetcher, StepWatchdog
from repro_torch.data.tokens import lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.roofline import BF16_FLOPS
from repro_torch.launch.serve import torch_ops
from repro_torch.models import convert, lm
from repro_torch.models.common import ModelConfig
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train.train_loop import load_train_state, train_state_tree
from repro_torch.utils.tree import tree_map


def narrow_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` at its own depth, segments and attention knobs but tiny
    widths: the same PyTorch calls a step, at a cost the CPU can pay."""
    return dataclasses.replace(
        cfg, d_model=64, n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab=512,
        vision_prefix=min(cfg.vision_prefix, 8),
        param_dtype="float32", compute_dtype="float32")


def count_step_ops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """PyTorch calls of one train step of ``cfg``'s depth at tiny widths
    on the CPU (forward, remat's recomputed forward, backward, AdamW)."""
    small = narrow_config(cfg)
    params = lm.init_lm(small, 0, "cpu")
    ocfg = OptConfig()
    opt = init_opt_state(params, ocfg)
    step = make_train_step(small, ocfg)
    b = lm_batch(small, batch, seq, 0)
    return torch_ops(lambda: step(params, opt, b))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="make this step fail once (a restore drill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh == "local":
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = make_local_mesh(1, n_dev, dev)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=dev)
    rules = shardings.Rules(mesh=mesh, fsdp=not args.smoke)
    ocfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_lm(cfg, 0, mesh.distinct_devices[0])
    shapes = convert.param_shapes(cfg, params)
    pspec = shardings.param_specs(rules, shapes)
    shardings.check_specs(shapes, pspec, mesh)      # the placement
    opt = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, mesh=mesh, param_specs=pspec)

    mgr = CheckpointManager(args.ckpt_dir)

    def restore(opt):
        target = tree_map(lambda x: ArraySpec(x.shape, x.dtype),
                          train_state_tree(cfg, params, opt))
        saved, tree = mgr.restore(target)
        opt = load_train_state(cfg, tree, params, opt)
        print(f"[launcher] restored step {saved}", flush=True)
        return int(opt.step), opt

    start = resumed = 0
    if mgr.latest() is not None:
        start, opt = restore(opt)
        resumed = start
        print(f"[launcher] resumed at step {start}", flush=True)

    # fault-tolerant loop: a failing step triggers restore-and-retry
    retries, losses, step_s = 0, {}, []
    fail_at = args.fail_at_step
    t0 = time.perf_counter()
    while True:
        pf = Prefetcher(lambda s: lm_batch(cfg, args.batch, args.seq, s),
                        start_step=start)
        wd = StepWatchdog()
        try:
            for step, batch in pf:
                if step >= args.steps:
                    break
                wd.start()
                if step == fail_at:
                    fail_at = -1
                    raise RuntimeError(f"injected failure at step {step}")
                params, opt, metrics = step_fn(params, opt, batch)
                losses[step] = float(metrics["loss"])    # syncs the device
                wd.stop(step)
                step_s.append(wd.times[-1])
                if step % 10 == 0:
                    print(f"[launcher] step {step} "
                          f"loss={losses[step]:.4f}", flush=True)
                if step and step % args.ckpt_every == 0:
                    mgr.save(step, train_state_tree(cfg, params, opt))
                start = step + 1
            break
        except Exception as e:                            # noqa: BLE001
            retries += 1
            print(f"[launcher] step failed ({e}); retry {retries}",
                  flush=True)
            mgr.wait()                  # publish the save still in flight
            if retries > args.max_retries or mgr.latest() is None:
                raise
            start, opt = restore(opt)
        finally:
            pf.stop()
    mgr.wait()
    seconds = time.perf_counter() - t0
    print(f"[launcher] finished at step {start}; stragglers: "
          f"{len(wd.flagged)}", flush=True)

    n_params = lm.param_count(cfg)
    tokens = args.batch * args.seq
    timed = step_s[1:] or step_s
    step_med = statistics.median(timed) if timed else float("nan")
    return {
        "arch": args.arch, "smoke": args.smoke, "device": str(dev),
        "layers": cfg.n_layers, "params": n_params,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "remat": cfg.remat, "tokens_per_step": tokens,
        "mesh": dict(mesh.shape), "fsdp": rules.fsdp,
        "param_bytes_per_device": shardings.sharded_bytes(shapes, pspec,
                                                          mesh),
        "resumed_at": resumed, "final_step": start, "retries": retries,
        "losses": [losses[s] for s in sorted(losses)],
        "loss_steps": sorted(losses), "step_s": step_s,
        "step_s_median": step_med, "tokens_per_s": tokens / step_med,
        "seconds": seconds, "stragglers": len(wd.flagged),
        "step_flops": 8 * n_params * tokens,
        "step_bound_ms": 8 * n_params * tokens / BF16_FLOPS * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "params_module": params, "opt_state": opt,
    }


if __name__ == "__main__":
    main()

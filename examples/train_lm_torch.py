"""End-to-end training example on the PyTorch port: train a qwen2-family
model on the synthetic motif stream, with checkpoint/restart (the port of
examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --full
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

A reduced width is the default (``tiny_config``, 1.5M parameters);
``--full`` trains ``hundred_m_config`` (54M: the JAX example's config,
named for its target size).
Checkpoints hold the JAX package's training-state tree, so either
package's example resumes from the other's. ``main`` returns the loss
history.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.ckpt import ArraySpec, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, StepWatchdog
from repro_torch.data.tokens import lm_batch
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.train import OptConfig, init_opt_state, make_train_step
from repro_torch.train.train_loop import load_train_state, train_state_tree
from repro_torch.utils.tree import tree_map


def hundred_m_config() -> ModelConfig:
    """~100M params: qwen2-style, 12 layers, d=512."""
    base = get_config("qwen2-1.5b")
    return dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv=2, head_dim=64,
        d_ff=2048, vocab=8192, segments=((12, ("attn_mlp",)),),
        param_dtype="float32", compute_dtype="float32",
        attn_chunk_threshold=4096)


def tiny_config() -> ModelConfig:
    base = hundred_m_config()
    return dataclasses.replace(
        base, n_layers=4, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=512, vocab=2048, segments=((4, ("attn_mlp",)),))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = hundred_m_config() if args.full else tiny_config()
    ocfg = OptConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                     weight_decay=0.01)
    n_params = lm.param_count(cfg)
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    params = lm.init_lm(cfg, 0, args.device)
    opt = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg)
    mgr = CheckpointManager(args.ckpt_dir)

    start = 0
    if mgr.latest() is not None:                       # fault-tolerant resume
        target = tree_map(lambda x: ArraySpec(x.shape, x.dtype),
                          train_state_tree(cfg, params, opt))
        _, restored = mgr.restore(target)
        opt = load_train_state(cfg, restored, params, opt)
        start = int(opt.step)
        print(f"resumed at step {start}")

    pf = Prefetcher(lambda s: lm_batch(cfg, args.batch, args.seq, s),
                    start_step=start)
    wd = StepWatchdog()
    history = []
    t0 = time.time()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            wd.start()
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            slow = wd.stop(step)
            history.append(loss)
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f}"
                      + ("  [straggler]" if slow else ""))
            if step and step % args.ckpt_every == 0:
                mgr.save(step, train_state_tree(cfg, params, opt))
    finally:
        pf.stop()
        mgr.wait()
    print(f"done in {time.time()-t0:.0f}s; stragglers flagged: "
          f"{len(wd.flagged)}")
    return {"params": n_params, "start": start, "losses": history}


if __name__ == "__main__":
    main()

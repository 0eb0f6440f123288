"""Serving launcher: prefill and decode a batch of requests.
Counterpart of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --device cpu --requests 8 --prompt-len 32 --new-tokens 16

Runs on the card unless ``--device cpu`` is given. ``main`` also returns
its numbers: parameters and their bytes as stored, prefill seconds and
tokens/s, decode ms/token (median of steps 2 onward) and tokens/s,
PyTorch calls per decode step, the bytes a decode step must read (the
weights once as the step reads them, plus the KV or SSM state) and that
over the card's memory rate, and on the card its peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import HBM_BYTES_PER_S
from repro_torch.models import lm
from repro_torch.serve.decode import generate, make_decode_step, \
    make_prefill


def torch_ops(fn) -> int:
    """PyTorch operator calls made by ``fn()``, counted by a dispatch
    mode."""
    from torch.utils._python_dispatch import TorchDispatchMode
    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return n[0]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_read_bytes(params: lm.TransformerLM, caches) -> int:
    """Bytes one decode step must read: every weight once as stored, but
    of the embedding only the head's use when tied (a step gathers B of
    its rows otherwise), plus every cache tensor."""
    weights = _nbytes(p for name, p in params.named_parameters()
                      if name != "embed" or params.lm_head is None)
    state = _nbytes(t for seg in caches for layer in seg for c in layer
                    for entry in c.values() for t in entry)
    return weights + state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-repeat", type=int, default=0,
                    help="cut every segment to at most this many repeats "
                         "(depth only; 0 keeps the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.max_repeat:
        segs = tuple((min(r, args.max_repeat), p) for r, p in cfg.segments)
        cfg = dataclasses.replace(
            cfg, segments=segs, n_layers=sum(r * len(p) for r, p in segs))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_lm(cfg, 0, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)) \
        .astype(np.int32)

    timings: dict = {}
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, args.new_tokens,
                   temperature=args.temperature, timings=timings)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0

    # one more step after a fresh prefill, for its PyTorch calls and the
    # bytes it reads
    serving = lm.cast_for_compute(params)
    max_t = args.prompt_len + args.new_tokens + 8
    _, caches = make_prefill(cfg, max_t)(
        serving, {"tokens": torch.as_tensor(prompts).to(dev)})
    step = make_decode_step(cfg)
    tok = torch.as_tensor(out[:, :1]).to(dev)
    ops_per_step = torch_ops(lambda: step(serving, caches, tok))
    read = step_read_bytes(serving, caches)
    del caches, serving

    steps = timings["step_s"][1:] or timings["step_s"]
    step_ms = statistics.median(steps) * 1e3 if steps else float("nan")
    total_new = args.requests * args.new_tokens
    res = {
        "arch": args.arch, "smoke": args.smoke, "device": str(dev),
        "layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
        "requests": args.requests, "prompt_len": args.prompt_len,
        "new_tokens": args.new_tokens,
        "params": lm.param_count(cfg),
        "param_bytes": _nbytes(params.parameters()),
        "seconds": dt,
        "prefill_s": timings["prefill_s"],
        "prefill_tok_s": args.requests * args.prompt_len
        / timings["prefill_s"],
        "decode_ms_per_token": step_ms,
        "decode_tok_s": args.requests / (step_ms / 1e3),
        "torch_ops_per_step": ops_per_step,
        "step_read_bytes": read,
        "step_bound_ms": read / HBM_BYTES_PER_S * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "first_request": out[0].tolist(),
    }
    print(f"[serve] {args.arch} ({'smoke' if args.smoke else 'full'}, "
          f"{cfg.n_layers} layers, {dev}): {args.requests} requests × "
          f"{args.new_tokens} tokens in {dt:.2f}s ({total_new / dt:.1f} "
          f"tok/s); prefill {res['prefill_s']:.3f}s, decode "
          f"{step_ms:.2f} ms/token")
    print("first request:", res["first_request"])
    return res


if __name__ == "__main__":
    main()

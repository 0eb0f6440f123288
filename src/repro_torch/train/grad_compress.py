"""Int8 error-feedback gradient all-reduce (distributed-optimization trick).
Counterpart of ``repro.train.grad_compress``.

Quantize local gradients to int8 (blockwise absmax), sum the int8 payload
(as int32 accumulators to avoid overflow), dequantize, and keep the
quantization residual as local error feedback added to the next step's
gradient. Cuts DP all-reduce bytes 4× (f32) / 2× (bf16) at equal asymptotic
convergence (error feedback makes the bias vanish).

Single-controller, as the port's sharded search (``core.distributed``):
one process holds the S data shards' gradient trees and error states and
reduces them in turn, where the JAX package runs one copy per device under
``shard_map`` and reduces with ``pmax``/``psum``. Each block's scale is
shared across shards (the max of the shards' block absmax, ÷ 127), so the
int8 sum is exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

QBLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    nb = -(-flat.shape[0] // QBLOCK)
    return F.pad(flat, (0, nb * QBLOCK - flat.shape[0])).reshape(nb, QBLOCK)


def _one(gs: list, es: list):
    """One leaf over the shards: (mean gradient, [new error feedback])."""
    shape, n, dtype = gs[0].shape, gs[0].numel(), gs[0].dtype
    blocks = [_blocks(g.float() + e) for g, e in zip(gs, es)]
    local_max = torch.stack([torch.amax(torch.abs(b), dim=1, keepdim=True)
                             for b in blocks])
    # a tensor divisor: a CUDA kernel multiplies by the reciprocal of a
    # Python scalar, which is not the division the CPU (and XLA) makes
    amax = torch.amax(local_max, dim=0)
    scale = amax / amax.new_full((), 127.0)
    qs = [torch.round(b / torch.clamp(scale, min=1e-12)).to(torch.int8)
          for b in blocks]
    new_es = [(b - q.float() * scale).reshape(-1)[:n].reshape(shape)
              for b, q in zip(blocks, qs)]
    summed = qs[0].to(torch.int32)
    for q in qs[1:]:
        summed = summed + q.to(torch.int32)
    deq = (summed.float() * scale).reshape(-1)[:n].reshape(shape) / len(gs)
    return deq.to(dtype), new_es


def compressed_psum_grads(grads: list, error_fb: list):
    """All-reduce S shards' gradient trees in int8 with error feedback.

    ``grads[s]`` and ``error_fb[s]`` are shard s's trees (the same
    structure). Returns ``(mean_grads, new_error_fb)``: one tree of means,
    which every shard receives, and the list of the shards' new error
    feedback trees."""
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in error_fb]
    out = [_one([f[i] for f in flat_g], [f[i] for f in flat_e])
           for i in range(len(flat_g[0]))]
    mean = tree_unflatten(grads[0], [o[0] for o in out])
    new_e = [tree_unflatten(grads[0], [o[1][s] for o in out])
             for s in range(len(grads))]
    return mean, new_e


def init_error_feedback(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)

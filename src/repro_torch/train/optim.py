"""In-house AdamW with optional int8-quantized moments.
Counterpart of ``repro.train.optim``.

The int8 moment store (blockwise absmax quantization, 128-element blocks)
cuts optimizer-state bytes from 8 to ~2 per parameter.

Trees are the port's (``utils.tree``): dicts, tuples, ``NamedTuple``s of
tensors, or an ``nn.Module`` for its parameters (keyed by their names).
:func:`adamw_update` keeps ``repro``'s order of operations leaf by leaf,
but writes the new parameters and moments into the tensors it was given,
as a jitted step with donated buffers would: a step holds one leaf's
temporaries at a time, not a second copy of the model and its moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    int8_moments: bool = False


QBLOCK = 128


class Q8(NamedTuple):
    """Blockwise-int8 quantized tensor.

    Shape-preserving: ``q`` has the parameter's own shape (last dim padded
    to a QBLOCK multiple) and ``scale`` replaces the last dim by the block
    count. ``last`` is static data, not a leaf (``tree_aux``)."""
    q: torch.Tensor        # (*shape[:-1], nb*QBLOCK) int8
    scale: torch.Tensor    # (*shape[:-1], nb) float32
    last: int              # original last-dim size (static)

    tree_aux = ("last",)


def q8_quantize(x: torch.Tensor) -> Q8:
    """Per block of 128 along the last dim: scale = absmax / 127, q =
    round-half-even(x / scale) (``torch.round`` rounds as ``jnp.round``)."""
    x = x.float()
    if x.ndim == 0:
        x = x[None]
    last = x.shape[-1]
    nb = -(-last // QBLOCK)
    pad = nb * QBLOCK - last
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], nb, QBLOCK)
    # a tensor divisor: a CUDA kernel multiplies by the reciprocal of a
    # Python scalar, which is not the division the CPU (and XLA) makes
    amax = torch.amax(torch.abs(blocks), dim=-1)                 # (..., nb)
    scale = amax / amax.new_full((), 127.0)
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-12))
    return Q8(q=q.reshape(*x.shape[:-1], nb * QBLOCK).to(torch.int8),
              scale=scale, last=last)


def q8_dequantize(t: Q8) -> torch.Tensor:
    nb = t.scale.shape[-1]
    blocks = t.q.reshape(*t.q.shape[:-1], nb, QBLOCK).float()
    out = blocks * t.scale[..., None]
    return out.reshape(*t.q.shape[:-1], nb * QBLOCK)[..., :t.last]


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    m: object              # tree of tensors or Q8
    v: object


def init_opt_state(params, cfg: OptConfig) -> OptState:
    """Zero moments (float32, or Q8 of zeros) shaped as ``params``'s
    leaves, on their devices."""
    def zero_like(x):
        z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return q8_quantize(z) if cfg.int8_moments else z
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zero_like, params),
                    v=tree_map(zero_like, params))


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of the peak."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, params, state: OptState, cfg: OptConfig):
    """One AdamW step (with optional clip + quantized moments), leaf by
    leaf in ``repro``'s order of operations. The parameters and moments
    are updated in place; returns ``(params, new_state, metrics)`` with
    ``params`` as given (a module stays a module)."""
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(state.step, cfg)
    t = state.step.float() + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = _moment_leaves(state.m), _moment_leaves(state.v)
    assert len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale
        m_f = q8_dequantize(m) if isinstance(m, Q8) else m
        v_f = q8_dequantize(v) if isinstance(v, Q8) else v
        m_new = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_new = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype))
        _store(m, m_new)
        _store(v, v_new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=state.step + 1, m=state.m, v=state.v), \
        metrics


def _moment_leaves(tree) -> list:
    """The moment tree's leaves with each Q8 kept whole."""
    return tree_leaves(tree, is_leaf=lambda x: isinstance(x, Q8))


def _store(dst, new: torch.Tensor) -> None:
    if isinstance(dst, Q8):
        qn = q8_quantize(new)
        dst.q.copy_(qn.q)
        dst.scale.copy_(qn.scale)
    else:
        dst.copy_(new)

"""Dense FFN blocks: SwiGLU (llama-family) and GELU (starcoder2-style).
Counterpart of ``repro.models.mlp``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, ParamGroup, dense_init,
                                       pdtype)


class MLPParams(ParamGroup):
    """w_gate (D, F) — None for non-gated; w_up (D, F); w_down (F, D)."""
    FIELDS = ("w_gate", "w_up", "w_down")


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
             device=None) -> MLPParams:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    gated = cfg.mlp_type == "swiglu"
    return MLPParams(
        w_gate=dense_init(gen, (d, f), dt, device=device) if gated else None,
        w_up=dense_init(gen, (d, f), dt, device=device),
        w_down=dense_init(gen, (f, d), dt, device=device))


def mlp_forward(p: MLPParams, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    up = x @ p.w_up.to(dt)
    if p.w_gate is not None:
        h = F.silu(x @ p.w_gate.to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")       # jax.nn.gelu's default form
    return h @ p.w_down.to(dt)

"""Block composition: pre-norm residual blocks of each kind.
Counterpart of ``repro.models.blocks``.

Kinds:
  attn_mlp   — attention + dense FFN (llama/qwen/starcoder/musicgen/internlm)
  attn_moe   — attention + MoE FFN (mixtral)
  mamba      — pure Mamba-2 (mamba2 arch: no separate FFN)
  mamba_mlp  — Mamba-2 + dense FFN (jamba non-MoE layers)
  mamba_moe  — Mamba-2 + MoE FFN (jamba MoE layers)
  arctic     — attention + (dense FFN ∥ MoE) residual (snowflake-arctic)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.common import ModelConfig, frozen, pdtype, rms_norm

KINDS = ("attn_mlp", "attn_moe", "mamba", "mamba_mlp", "mamba_moe", "arctic")
ATTN_KINDS = ("attn_mlp", "attn_moe", "arctic")


class Block(nn.Module):
    """One layer's parameters: ``ln1`` and ``attn`` or ``ssm``; ``ln2`` with
    ``mlp`` and/or ``moe`` where the kind has an FFN. Absent parts are
    None, as the JAX package's block dict lacks their keys."""

    def __init__(self, kind: str, ln1, attn=None, ssm=None, ln2=None,
                 mlp=None, moe=None):
        super().__init__()
        self.kind = kind
        self.ln1 = frozen(ln1)
        self.ln2 = frozen(ln2)
        self.attn, self.ssm, self.mlp, self.moe = attn, ssm, mlp, moe


def zero_aux(device=None) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "drop_frac": z}


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def init_block(gen, kind: str, cfg: ModelConfig, device=None) -> Block:
    d = cfg.d_model
    dt = pdtype(cfg)
    dev = gen.device if gen is not None else device

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    parts = {}
    if kind in ATTN_KINDS:
        parts["attn"] = A.init_attn(gen, cfg, device)
    else:
        parts["ssm"] = S.init_ssm(gen, cfg, device)
    if kind in ("attn_mlp", "mamba_mlp", "arctic"):
        parts["mlp"] = M.init_mlp(gen, cfg, device=device)
    if kind in ("attn_moe", "mamba_moe", "arctic"):
        parts["moe"] = MOE.init_moe(gen, cfg, device)
    has_ffn = "mlp" in parts or "moe" in parts
    return Block(kind, ones(), ln2=ones() if has_ffn else None, **parts)


def _ffn(kind: str, p: Block, x, cfg: ModelConfig):
    """The block's second residual branch: (x, aux or None)."""
    if kind in ("attn_mlp", "mamba_mlp"):
        return x + M.mlp_forward(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps),
                                 cfg), None
    if kind in ("attn_moe", "mamba_moe"):
        mo, maux = MOE.moe_forward(p.moe, rms_norm(x, p.ln2, cfg.norm_eps),
                                   cfg)
        return x + mo, maux
    if kind == "arctic":
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        mo, maux = MOE.moe_forward(p.moe, h2, cfg)
        return x + M.mlp_forward(p.mlp, h2, cfg) + mo, maux
    return x, None


def block_forward(kind: str, p: Block, x, cfg: ModelConfig):
    """Train/prefill forward without cache. Returns (x, aux)."""
    aux = zero_aux(x.device)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, _ = A.attention_forward(p.attn, h, cfg)
    else:
        out = S.ssm_forward(p.ssm, h, cfg)
    x, maux = _ffn(kind, p, x + out, cfg)
    if maux is not None:
        aux = _add_aux(aux, maux)
    return x, aux


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_t: int,
                     dtype, device=None) -> dict:
    if kind in ATTN_KINDS:
        return {"attn": A.init_kv_cache(cfg, batch, max_t, dtype, device)}
    return {"ssm": S.init_ssm_state(cfg, batch, dtype, device)}


def block_prefill(kind: str, p: Block, x, cfg: ModelConfig, max_t: int,
                  dtype):
    """Prefill: forward + produce the decode cache. Returns (x, aux, cache)."""
    aux = zero_aux(x.device)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind in ATTN_KINDS:
        cache0 = A.init_kv_cache(cfg, x.shape[0], max_t, dtype, x.device)
        out, cache_kv = A.attention_forward(p.attn, h, cfg, cache=cache0)
        cache = {"attn": cache_kv}
    else:
        out, st = S.ssm_forward(p.ssm, h, cfg, return_state=True)
        cache = {"ssm": st}
    x, maux = _ffn(kind, p, x + out, cfg)
    if maux is not None:
        aux = _add_aux(aux, maux)
    return x, aux, cache


def block_decode(kind: str, p: Block, x, cache: dict, cfg: ModelConfig):
    """One-token decode. Returns (x, cache), the cache updated in place."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, _ = A.decode_attention(p.attn, h, cache["attn"], cfg)
    else:
        out, _ = S.ssm_decode(p.ssm, h, cache["ssm"], cfg)
    x, _ = _ffn(kind, p, x + out, cfg)
    return x, cache

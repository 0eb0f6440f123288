"""Architecture + shape registry: the assigned (arch × shape) grid.
Counterpart of ``repro.configs.registry``.

``input_specs`` returns ``meta``-device tensors standing in for every model
input (shapes and dtypes, no allocation).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import (arctic_480b, deepseek_7b, internvl2_2b,
                                 jamba_v0_1_52b, mamba2_2_7b, mixtral_8x22b,
                                 musicgen_medium, qwen2_1_5b, qwen2_7b,
                                 starcoder2_7b)
from repro_torch.models.common import ModelConfig, MoEConfig, SSMConfig

ARCHS: dict = {
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "starcoder2-7b": starcoder2_7b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: dict = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def list_archs() -> list:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch]


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention (SSM / hybrid / SWA ring);
    pure full-attention archs skip it."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta``-device stand-ins for every data input of the step fn."""
    b, s = shape.global_batch, shape.seq_len
    emb_dt = getattr(torch, cfg.compute_dtype)

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    def emb(shape_):
        return torch.empty(shape_, dtype=emb_dt, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            specs = {"frame_embeds": emb((b, s, cfg.d_model))}
            if shape.kind == "train":
                specs["targets"] = tok((b, s))
            return specs
        if cfg.frontend == "vision":
            p = cfg.vision_prefix
            specs = {"patch_embeds": emb((b, p, cfg.d_model)),
                     "tokens": tok((b, s - p))}
            if shape.kind == "train":
                specs["targets"] = tok((b, s - p))
            return specs
        specs = {"tokens": tok((b, s))}
        if shape.kind == "train":
            specs["targets"] = tok((b, s))
        return specs

    # decode: one new token against a seq_len cache
    return {"tokens": tok((b, 1))}


# ---------------------------------------------------------------------------
# reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def smoke_config(arch: str) -> ModelConfig:
    cfg = ARCHS[arch]
    segs = tuple((min(r, 2), period) for r, period in cfg.segments)
    moe = None
    if cfg.moe is not None:
        # high capacity factor -> drop-free routing, so decode == forward
        # exactly
        moe = MoEConfig(n_experts=min(cfg.moe.n_experts, 4),
                        top_k=min(cfg.moe.top_k, 2),
                        capacity_factor=8.0,
                        group_size=64, dispatch=cfg.moe.dispatch)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16,
                        conv_width=cfg.ssm.conv_width, n_groups=1)
    n_layers = sum(r * len(p) for r, p in segs)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers, d_model=64,
        n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab=512,
        segments=segs, moe=moe, ssm=ssm,
        vision_prefix=min(cfg.vision_prefix, 8),
        window=min(cfg.window, 32) if cfg.window else 0,
        attn_chunk_q=16, attn_chunk_kv=16, attn_chunk_threshold=64,
        param_dtype="float32", compute_dtype="float32")

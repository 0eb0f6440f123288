"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d=6144, 48H (GQA kv=8),
d_ff=16384, vocab=32768, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=32768,
    segments=((56, ("attn_moe",)),),
    mlp_type="swiglu", rope_theta=1e6,
    window=4096,                       # SWA -> long-context decode feasible
    moe=MoEConfig(n_experts=8, top_k=2, group_size=16384),
)

"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 35L, d=7168,
56H (GQA kv=8), d_ff=4864, vocab=32000, MoE 128 experts top-2 with a dense
FFN residual running in parallel (dense-MoE hybrid)."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=4864, vocab=32000,
    segments=((35, ("arctic",)),),
    mlp_type="swiglu", rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=2, group_size=16384),
)

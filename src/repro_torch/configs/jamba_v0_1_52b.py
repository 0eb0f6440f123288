"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: 32L, d=4096, 32H (GQA kv=8),
d_ff=14336, vocab=65536, MoE 16e top-2. Mamba:attention 7:1 interleave
(attention at layer index 4 of each period-8 block), MoE on every other
layer. Jamba's Mamba-1 layers are realized with the SSD (Mamba-2) dual form
here (d_state=16 as in the original)."""
from repro_torch.models.common import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=65536,
    segments=((4, ("mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe",
                   "attn_mlp", "mamba_moe", "mamba_mlp", "mamba_moe")),),
    mlp_type="swiglu", rope_theta=1e6,
    moe=MoEConfig(n_experts=16, top_k=2, group_size=16384),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2),
)

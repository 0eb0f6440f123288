"""Mamba2-2.7B [arXiv:2405.21060]: 64L, d=2560, attention-free SSD,
d_state=128, headdim=64, expand=2 (d_inner=5120, 80 heads),
vocab=50280 (padded to 50304)."""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64, d_model=2560, n_heads=1, n_kv=1, head_dim=64,  # attn unused
    d_ff=0, vocab=50304,               # actual 50280, padded
    segments=((64, ("mamba",)),),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    tie_embeddings=True,
)

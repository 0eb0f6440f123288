"""Qwen2-1.5B [arXiv:2407.10671; hf]: 28L, d=1536, 12H (GQA kv=2),
d_ff=8960, vocab=151936, QKV bias."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, head_dim=128,
    d_ff=8960, vocab=151936,
    segments=((28, ("attn_mlp",)),),
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
)

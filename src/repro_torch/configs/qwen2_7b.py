"""Qwen2-7B [arXiv:2407.10671; hf]: 28L, d=3584, 28H (GQA kv=4),
d_ff=18944, vocab=152064, QKV bias."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944, vocab=152064,
    segments=((28, ("attn_mlp",)),),
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
)

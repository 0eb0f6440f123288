"""StarCoder2-7B [arXiv:2402.19173; hf]: 32L, d=4608, 36H (GQA kv=4),
d_ff=18432 (non-gated 4x GELU FFN), vocab=49152, RoPE, bias."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, head_dim=128,
    d_ff=18432, vocab=49152,
    segments=((32, ("attn_mlp",)),),
    mlp_type="gelu", qkv_bias=True, rope_theta=1e5,
)

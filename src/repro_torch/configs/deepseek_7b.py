"""DeepSeek-7B [arXiv:2401.02954; hf]: 30L, d=4096, 32H (MHA: kv=32),
d_ff=11008, vocab=102400, llama architecture."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=11008, vocab=102400,
    segments=((30, ("attn_mlp",)),),
    mlp_type="swiglu", rope_theta=1e4,
)

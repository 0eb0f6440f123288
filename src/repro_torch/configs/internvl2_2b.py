"""InternVL2-2B [arXiv:2404.16821; hf]: InternLM2-1.8B backbone — 24L,
d=2048, 16H (GQA kv=8), d_ff=8192, vocab=92553 (padded to 92672, a
multiple of 128). The InternViT frontend is a stub: ``input_specs``
supplies precomputed patch embeddings prepended to the token stream."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=8192, vocab=92672,            # actual 92553, padded
    segments=((24, ("attn_mlp",)),),
    mlp_type="swiglu", rope_theta=1e6,
    frontend="vision", vision_prefix=256,
)

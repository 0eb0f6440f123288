"""MusicGen-medium [arXiv:2306.05284; hf]: 48L, d=1536, 24H (MHA),
d_ff=6144 (4x GELU), vocab=2048 (EnCodec codebook). Decoder-only over
EnCodec tokens; the audio frontend is a stub — ``input_specs`` supplies
precomputed frame embeddings (B, S, D)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, head_dim=64,
    d_ff=6144, vocab=2048,
    segments=((48, ("attn_mlp",)),),
    mlp_type="gelu", rope_theta=1e4,
    frontend="audio",
)

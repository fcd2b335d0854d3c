"""MusicGen-medium [arXiv:2306.05284; hf-verified] — decoder over EnCodec
tokens; the EnCodec frontend is a stub providing frame embeddings."""

from .base import ArchConfig

MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284; hf",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,  # MHA
    head_dim=64,
    d_ff=6144,  # 4x GELU FFN
    vocab_size=2048,  # EnCodec codebook
    layer_pattern=("attn",),
    mlp_kind="gelu",
    frontend="audio_stub",
)

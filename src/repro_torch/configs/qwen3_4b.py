"""Qwen3-4B [hf:Qwen/Qwen3-8B family; hf-verified]."""

from .base import ArchConfig

QWEN3_4B = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B; hf",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    qk_norm=True,  # qwen3 signature feature
    rope_theta=1e6,
    tie_embeddings=True,
)

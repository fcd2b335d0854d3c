"""Phi-3-mini-3.8B [arXiv:2404.14219; unverified] — RoPE SwiGLU MHA."""

from .base import ArchConfig

PHI3_MINI = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219; unverified",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,  # full MHA (kv=32)
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1e4,
)

"""Mixtral-8x7B [arXiv:2401.04088; hf-verified] — 8 experts top-2 + SWA."""

from .base import ArchConfig

MIXTRAL_8X7B = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,  # per expert
    vocab_size=32000,
    layer_pattern=("swa",),
    window=4096,  # sliding-window attention
    mlp_kind="swiglu",
    rope_theta=1e6,
    moe=True,
    num_experts=8,
    experts_per_token=2,
    moe_every=1,
    sub_quadratic=True,  # SWA bounds the cache: runs long_500k
)

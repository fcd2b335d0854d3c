"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified] — Mistral-Nemo
backbone; the Pixtral-ViT frontend is a stub providing patch embeddings."""

from .base import ArchConfig

PIXTRAL_12B = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1e6,
    frontend="vision_stub",
)

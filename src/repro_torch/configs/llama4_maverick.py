"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout family;
unverified] — 128-expert top-1 MoE every other layer + shared expert,
early-fusion multimodal (frontend not modeled; text backbone)."""

from .base import ArchConfig

LLAMA4_MAVERICK = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # per routed expert / dense layer
    vocab_size=202048,
    layer_pattern=("attn", "attn"),  # (dense-MLP layer, MoE layer)
    mlp_kind="swiglu",
    rope_theta=5e5,
    moe=True,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,  # MoE on the 2nd layer of each period
    moe_shared_expert=True,
    capacity_factor=2.0,  # top-1 routing needs headroom
)

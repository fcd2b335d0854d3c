"""Granite-34B-Code [arXiv:2405.04324; hf-verified] — llama-arch, MQA."""

from .base import ArchConfig

GRANITE_34B = ArchConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324; hf",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1e5,
)

"""Yi-6B [arXiv:2403.04652; hf-verified] — llama-arch GQA."""

from .base import ArchConfig

YI_6B = ArchConfig(
    name="yi-6b",
    family="dense",
    source="arXiv:2403.04652; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=5e6,
)

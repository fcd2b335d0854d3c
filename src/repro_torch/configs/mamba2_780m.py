"""Mamba2-780m [arXiv:2405.21060; unverified] — attention-free SSD."""

from .base import ArchConfig

MAMBA2_780M = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=48,
    d_model=1536,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,  # no MLP: the SSD mixer is the block
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,  # O(1)-state decode: runs long_500k
)

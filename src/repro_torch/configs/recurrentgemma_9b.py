"""RecurrentGemma-9B [arXiv:2402.19427; unverified] — Griffin: RG-LRU with
local attention, 1 attention per 2 recurrent blocks."""

from .base import ArchConfig

RECURRENTGEMMA_9B = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427; unverified",
    num_layers=38,  # 12 x (rglru, rglru, local) + (rglru, rglru)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,  # MQA local attention
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,  # local attention window
    mlp_kind="swiglu",
    lru_width=4096,
    tie_embeddings=True,
    sub_quadratic=True,  # O(1) state + bounded window: runs long_500k
)

"""The LM substrate's dense, attention-only models (``repro.models``)."""

from .transformer import (
    ForwardResult,
    Model,
    block_spec,
    decode_step,
    forward,
    init_caches,
    init_model,
    layer_counts,
)

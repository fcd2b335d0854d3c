"""The LM substrate's models (``repro.models``): attention, MoE, SSM and
RG-LRU layers in one decoder stack, and the modality frontend stubs."""

from .transformer import (
    ForwardResult,
    Model,
    block_spec,
    decode_step,
    forward,
    init_caches,
    init_model,
    layer_counts,
    param_count,
)

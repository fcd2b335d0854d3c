"""LM training (``repro.training``): AdamW with an f32 master copy, the
train step with microbatch accumulation and per-block remat, and the
fault-tolerant trainer, on one device."""

"""Modality frontend stubs of the backbone-only architectures.

Counterpart of ``repro.models.frontends``: musicgen (audio) and pixtral
(vision) are specified as transformer backbones; their frontends are stubs
that hand the backbone precomputed frame or patch embeddings of the right
shape and dtype, here random ones drawn from an explicit
``torch.Generator`` on its device.  The backbone takes them through
``forward(..., embeds=...)``.
"""

from __future__ import annotations

import torch


def _normal_embeddings(generator, batch: int, seq: int, d_model: int, dtype):
    x = torch.randn(
        (batch, seq, d_model),
        generator=generator,
        dtype=torch.float32,
        device=generator.device,
    )
    return x.to(dtype) * 0.02


def audio_frame_embeddings(generator, batch: int, seq: int, d_model: int, dtype):
    """Stand-in for EnCodec frame embeddings (musicgen)."""
    return _normal_embeddings(generator, batch, seq, d_model, dtype)


def vision_patch_embeddings(generator, batch: int, seq: int, d_model: int, dtype):
    """Stand-in for Pixtral-ViT patch embeddings interleaved with text."""
    return _normal_embeddings(generator, batch, seq, d_model, dtype)


def frontend_embeddings(
    frontend: str, generator, batch: int, seq: int, d_model: int, dtype
):
    if frontend == "audio_stub":
        return audio_frame_embeddings(generator, batch, seq, d_model, dtype)
    if frontend == "vision_stub":
        return vision_patch_embeddings(generator, batch, seq, d_model, dtype)
    raise ValueError(f"frontend must be audio_stub or vision_stub, got {frontend!r}")

"""Shared model building blocks.

Counterpart of ``repro.models.common``.  Dtype policy as in the reference:
parameters and activations use the config dtype (bf16 on the card, f32 for
the CPU tests); normalization statistics and RoPE run in f32.  Weights are
drawn from a ``torch.Generator`` on the device they are made on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(shape, dtype, *, generator, device, scale: float | None = None):
    """Truncated-normal fan-in init of an (in, out) matrix, as the reference:
    N(0, 1) truncated to [-2, 2], times ``scale`` (default fan_in^-1/2)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in**-0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
    return (w * scale).to(dtype)


def embed_init(shape, dtype, *, generator, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


def linear(fan_in: int, fan_out: int, dtype, *, generator, device) -> nn.Linear:
    """A bias-free ``nn.Linear`` whose weight (out, in) is the transpose of
    ``dense_init((fan_in, fan_out))``: the reference's ``x @ w``."""
    layer = nn.Linear(fan_in, fan_out, bias=False, device="meta", dtype=dtype)
    w = dense_init((fan_in, fan_out), dtype, generator=generator, device=device)
    layer.weight = nn.Parameter(w.T.contiguous())
    return layer


def apply_linear(x, w):
    """``x @ W^T`` for an ``nn.Linear`` or its (out, in) weight ``W`` (a
    layer's weights gathered on a mesh come as tensors)."""
    return F.linear(x, w.weight if isinstance(w, nn.Linear) else w)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm with f32 statistics and ``1 + weight`` scaling."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    theta = torch.tensor(theta, dtype=torch.float32, device=device)
    return theta ** -(exponent / head_dim)  # (head_dim / 2,)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.float()[..., None] * freqs  # (..., seq, hd / 2)
    angles = angles[..., None, :]  # (..., seq, 1, hd / 2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def take_embedding(table, tokens):
    return table[tokens]

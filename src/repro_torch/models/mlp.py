"""Feed-forward blocks: SwiGLU (llama family) and GELU (musicgen).

Counterpart of ``repro.models.mlp``; ``MLP`` holds what ``MLPParams`` holds.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .common import linear


class MLP(nn.Module):
    """``w_gate`` (None for GELU), ``w_up``: d -> f; ``w_down``: f -> d."""

    def __init__(self, d: int, f: int, kind: str, dtype, *, generator, device):
        super().__init__()
        if kind not in ("swiglu", "gelu"):
            raise ValueError(kind)
        self.kind = kind
        kw = dict(generator=generator, device=device)
        self.w_gate = linear(d, f, dtype, **kw) if kind == "swiglu" else None
        self.w_up = linear(d, f, dtype, **kw)
        self.w_down = linear(f, d, dtype, **kw)

    def forward(self, x):
        if self.kind == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_up(x)
        else:
            h = F.gelu(self.w_up(x), approximate="tanh")  # jax.nn.gelu's default
        return self.w_down(h)

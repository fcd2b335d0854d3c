"""Feed-forward blocks: SwiGLU (llama family) and GELU (musicgen).

Counterpart of ``repro.models.mlp``; ``MLP`` holds what ``MLPParams`` holds.
On a mesh (``mlp`` with ``tp``) the block is tensor-parallel over "model":
``w_gate``/``w_up`` column-parallel (this rank's slice of the width),
``w_down`` row-parallel, then the sum over the axis.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..launch.mesh import copy_to_region, reduce_from_region
from .common import apply_linear, linear


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
        return mlp(self, x, self.kind)


def mlp(params, x, kind: str, tp=None):
    """The block on ``params`` (an ``MLP``, or its weights as tensors);
    ``tp`` (``shardspecs.ModelParallel``) makes it tensor-parallel."""
    group = None if tp is None else tp.group
    x = copy_to_region(x, group)
    if kind == "swiglu":
        h = F.silu(apply_linear(x, params.w_gate)) * apply_linear(x, params.w_up)
    else:
        h = F.gelu(apply_linear(x, params.w_up), approximate="tanh")  # jax's default
    return reduce_from_region(apply_linear(h, params.w_down), group)

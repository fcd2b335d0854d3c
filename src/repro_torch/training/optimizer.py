"""AdamW with mixed precision: an f32 master copy and f32 moments.

Counterpart of ``repro.training.optimizer`` on one device.  The state holds
``master``, ``m`` and ``v`` as lists with one float32 tensor a parameter, in
the model's parameter order (``model.parameters()``).  The reference's
update is functional; here it runs in place, leaf by leaf, under
``torch.no_grad()``: at full width a functional copy of the parameters would
take another 8 GB.  Each step ends with ``p.copy_(master)``, which casts as
``master.to(p.dtype)`` does, so ``p == master.to(p.dtype)`` bit for bit after
every step.  The learning rate, the bias corrections and the clip are
float32 tensors on the device, as the reference computes them.

On a mesh (ZeRO: ``opt_state_specs``) the state holds this rank's shards,
placed as the parameters are, and the update is elementwise on them; only
the gradients' norm, and so the clip, needs the other ranks:
``global_norm`` sums each leaf's squares over the axes it is sharded on,
and counts a replicated leaf once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    master: list  # f32 copy of the parameters
    m: list
    v: list


def param_list(params) -> list:
    """The parameters of a module in its order, or the tensors given."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


def adamw_init(params) -> AdamWState:
    """Step 0, an exact float32 copy of each parameter, zero moments."""
    params = param_list(params)
    dev = params[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=[p.detach().to(torch.float32, copy=True) for p in params],
        m=[zeros(p) for p in params],
        v=[zeros(p) for p in params],
    )


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    span = max(cfg.decay_steps - cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm, decayed)


def opt_state_specs(p_specs) -> AdamWState:
    """The specs of the ``AdamWState`` of parameters of specs ``p_specs``
    (one a parameter, in the model's order): ZeRO sharding, the moments and
    the master placed as their parameters, the step replicated."""
    return AdamWState(step=(), master=list(p_specs), m=list(p_specs), v=list(p_specs))


def global_norm(tensors, shardings=None):
    """sqrt of the sum of squares of every element, in float32.  With
    ``shardings`` (a ``distribution.sharding.Sharding`` a tensor: each is
    this rank's shard) each leaf's squares are summed over the axes it is
    sharded on only, so a replicated leaf counts once; every rank gets the
    same norm (collective)."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))
    from ..launch.mesh import axis_group, group_sum
    from ..models.shardspecs import entry_axes

    sums = {}
    for x, sh in zip(tensors, shardings, strict=True):
        axes = {n for e in sh.spec for n in entry_axes(e)}
        key = tuple(a for a in sh.mesh.mesh_dim_names if a in axes)
        part = torch.sum(torch.square(x.float()))
        sums[key] = part if key not in sums else sums[key] + part
    mesh, total = shardings[0].mesh, 0
    for key, part in sums.items():
        total = total + group_sum(part, axis_group(mesh, key) if key else None)
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, shardings=None):
    """One step, in place: (params, the state with its step advanced,
    metrics ``grad_norm`` and ``lr``).  ``master``, ``m`` and ``v`` are
    updated in place, so ``state`` itself sees the step's moments.  On a
    mesh, ``shardings`` places each parameter (``global_norm``)."""
    plist = param_list(params)
    step = state.step + 1
    gnorm = global_norm(grads, shardings)
    clip = torch.clamp(
        _f32(cfg.grad_clip_norm, gnorm) / torch.clamp(gnorm, min=1e-12), max=1.0
    )
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
    for p, g, m, v, master in zip(
        plist, grads, state.m, state.v, state.master, strict=True
    ):
        g = g.float() * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)  # g is spent
        delta = torch.div(m, bc1).div_(denom)
        delta.add_(master, alpha=cfg.weight_decay).mul_(lr)
        master.sub_(delta)
        p.copy_(master)  # the cast of master.to(p.dtype)
    new_state = AdamWState(step=step, master=state.master, m=state.m, v=state.v)
    return params, new_state, dict(grad_norm=gnorm, lr=lr)

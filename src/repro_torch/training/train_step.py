"""The training step: loss, microbatch accumulation, mixed precision, remat,
optional compressed gradient reduction.

Counterpart of ``repro.training.train_step`` on one device.  The model is
the port's ``Model``; gradients come from ``torch.autograd.grad`` in the
parameters' dtypes (bf16 parameters have bf16 gradients, as in JAX), one
tensor a parameter in the model's parameter order.  ``train_step`` updates
the model and the optimizer state in place and returns them.

A step whose loss is not finite leaves the model, the optimizer state and
the compression errors as it found them.  The reference's step is
functional and returns the non-finite state, which its trainer then throws
away; an in-place step must decide before it writes, so the trainer ends
in the reference's state either way.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..distribution.compression import quantize_dequantize_psum_sim
from ..models.transformer import forward
from .optimizer import AdamWConfig, adamw_update, global_norm, lr_schedule, param_list

MESH_REFUSAL = (
    "a train step over a device mesh (param, optimizer and data shardings) "
    "belongs to the multi-device forms (ROADMAP Queue 1 item 7); pass mesh=None"
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    attn_impl: str = "naive"  # naive | chunked
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2
    compress_cross_pod: bool = False
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _on_device(batch: dict, dev) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``dev``."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def loss_fn(model, cfg, batch, tcfg: TrainConfig):
    """(total loss, metrics): mean next-token NLL plus the z-loss and the MoE
    aux loss.  The label logit is a gather of the f32 logits; the
    reference's one-hot contraction gives the same number, every other
    term being 0 * x, without a (B, S, V) one-hot."""
    batch = _on_device(batch, model.embed.device)
    out = forward(
        model,
        cfg,
        tokens=batch.get("tokens"),
        embeds=batch.get("embeds"),
        remat=tcfg.remat,
        attn_impl=tcfg.attn_impl,
    )
    logits = out.logits.float()
    targets = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = -torch.mean(label_logit - logz)
    zl = tcfg.z_loss * torch.mean(logz**2)
    total = nll + zl + tcfg.aux_loss_weight * out.aux_loss
    n_tok = torch.tensor(float(targets.numel()), device=logits.device)
    metrics = dict(loss=total, nll=nll, aux=out.aux_loss, tokens=n_tok)
    return total, metrics


def _split_microbatches(batch: dict, n: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}


def grads_fn(model, cfg, batch, tcfg: TrainConfig):
    """(gradients, one a parameter, metrics).  With ``microbatches`` > 1 the
    batch is split along its first axis and the gradients are summed into
    float32 zeros, then divided; the metrics are the microbatches' means."""
    params = param_list(model)

    def value_and_grad(b):
        loss, metrics = loss_fn(model, cfg, b, tcfg)
        grads = torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True
        )
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    if tcfg.microbatches <= 1:
        return value_and_grad(batch)
    mb = _split_microbatches(_on_device(batch, model.embed.device), tcfg.microbatches)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    metrics = []
    for i in range(tcfg.microbatches):
        grads, m = value_and_grad({k: v[i] for k, v in mb.items()})
        for a, g in zip(acc, grads):
            a.add_(g)
        del grads
        metrics.append(m)
    for a in acc:
        a.div_(tcfg.microbatches)
    return acc, {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


def train_step(model, opt_state, grad_errors, batch, *, cfg, tcfg: TrainConfig):
    """(model, opt_state, grad_errors, metrics), the first two updated in
    place; metrics ``loss``, ``nll``, ``aux``, ``tokens``, ``grad_norm``,
    ``lr`` as float32 scalars on the device.  A non-finite loss applies
    nothing (see the module note)."""
    grads, metrics = grads_fn(model, cfg, batch, tcfg)
    new_errors = grad_errors
    if tcfg.compress_cross_pod:
        grads, new_errors = quantize_dequantize_psum_sim(grads, grad_errors)
    if not bool(torch.isfinite(metrics["loss"])):
        metrics.update(
            grad_norm=global_norm(grads),
            lr=lr_schedule(tcfg.optimizer, opt_state.step + 1),
        )
        return model, opt_state, grad_errors, metrics
    model, opt_state, opt_metrics = adamw_update(
        tcfg.optimizer, grads, opt_state, model
    )
    metrics.update(opt_metrics)
    return model, opt_state, new_errors, metrics


def make_train_step(cfg, mesh=None, tcfg: TrainConfig | None = None):
    """The single-device step ``step(model, opt_state, grad_errors, batch)``;
    a mesh raises (ROADMAP Queue 1 item 7)."""
    if mesh is not None:
        raise ValueError(MESH_REFUSAL)
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg or TrainConfig())

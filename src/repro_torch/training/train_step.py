"""The training step: loss, microbatch accumulation, mixed precision, remat,
optional compressed gradient reduction.

Counterpart of ``repro.training.train_step``.  The model is
the port's ``Model``; gradients come from ``torch.autograd.grad`` in the
parameters' dtypes (bf16 parameters have bf16 gradients, as in JAX), one
tensor a parameter in the model's parameter order.  ``train_step`` updates
the model and the optimizer state in place and returns them.

A step whose loss is not finite leaves the model, the optimizer state and
the compression errors as it found them.  The reference's step is
functional and returns the non-finite state, which its trainer then throws
away; an in-place step must decide before it writes, so the trainer ends
in the reference's state either way.

``make_train_step(cfg, mesh, tcfg)`` gives the step over a device mesh:
the model sharded by ``distribution.sharding.shard_params``, the optimizer
state and compression errors shards of the same placement, and each rank's
rows of the batch (``sharding.shard_batch``).  Its loss is the global
batch's: the vocabulary-sharded logsumexp takes its max and sum over
"model", the label logit too, and the means run over every data-parallel
rank's tokens (sums reduced with an identity backward, so each rank's
gradients are its rows' part).  After the backward pass each gradient is
summed over the data-parallel axes its parameter is not sharded on (the
FSDP gathers' backward already summed over "data" where it is), and
``q_norm``/``k_norm``'s over "model".  The non-finite decision is taken on
the reduced loss, so every rank takes it.

``compress_cross_pod`` quantises the global gradient in blocks of 256 of
the flat layout of each of the reference's leaves (``reference_leaves``):
the layers of one pattern position stacked, an ``nn.Linear``'s weight
transposed to the reference's (in, out), so that the blocks and their
scales are the reference's on one device and on a mesh alike.  Where this
rank's shard of such a leaf holds whole blocks in their order it is
quantised where it lies; any other leaf is gathered, quantised whole and
cut again.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..distribution.compression import quantize_dequantize_psum_sim
from ..distribution.sharding import (
    batch_axes,
    param_shardings,
    param_specs,
    shard_tensor,
    unshard_tensor,
)
from ..launch.mesh import (
    all_reduce_,
    axis_group,
    axis_size,
    group_sum,
    reduce_from_region,
)
from ..models import settings
from ..models.shardspecs import (
    MODEL_SUMMED,
    entry_axes,
    model_parallel,
    vocab_parallel,
)
from ..models.transformer import forward, layer_counts
from .optimizer import AdamWConfig, adamw_update, global_norm, lr_schedule, param_list


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
    mesh = settings.FSDP_GATHER_MESH
    logz, label_logit = _sharded_logz_and_label(logits, targets, cfg, mesh)
    dp = batch_axes(mesh)
    n_tok = targets.numel() * axis_size(mesh, dp)
    group = axis_group(mesh, dp)
    nll = -reduce_from_region(torch.sum(label_logit - logz), group) / n_tok
    zl = tcfg.z_loss * reduce_from_region(torch.sum(logz**2), group) / n_tok
    total = nll + zl + tcfg.aux_loss_weight * out.aux_loss
    n_tok = torch.tensor(float(n_tok), device=logits.device)
    metrics = dict(loss=total, nll=nll, aux=out.aux_loss, tokens=n_tok)
    return total, metrics


def _sharded_logz_and_label(logits, targets, cfg, mesh):
    """(logsumexp, label logit) of each token from this rank's vocabulary
    slice of its logits: max and sum over "model", the label logit summed
    from the rank that holds it (whole logits where not vocab-parallel)."""
    tp = model_parallel(mesh)
    if tp.group is None or not vocab_parallel(cfg):
        logz = torch.logsumexp(logits, dim=-1)
        return logz, torch.gather(logits, -1, targets[..., None])[..., 0]
    m = all_reduce_(logits.detach().amax(dim=-1), op="max", group=tp.group)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    logz = torch.log(reduce_from_region(sumexp, tp.group)) + m
    local = targets - tp.rank * logits.shape[-1]
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros((), device=logits.device))
    return logz, reduce_from_region(picked, tp.group)


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


def reduce_grads(grads, model, cfg, mesh) -> list:
    """Each rank's gradients (its shards' parts) summed as the module note
    says, in place, one ``all_reduce`` a group of axes and dtype."""
    specs, dp = param_specs(cfg), batch_axes(mesh)
    buckets = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        held = {n for e in specs[name] for n in entry_axes(e)}
        axes = tuple(a for a in dp if a not in held)
        if name.rsplit(".", 1)[-1] in MODEL_SUMMED:
            axes += ("model",)
        group = axis_group(mesh, axes) if axes else None
        if group is not None:
            buckets.setdefault((axes, grads[i].dtype), (group, []))[1].append(i)
    for group, idx in buckets.values():
        flat = group_sum(torch.cat([grads[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def reference_leaves(model, cfg) -> list:
    """The reference's parameter leaves as groups of the port's parameters,
    each ``(indices in parameter order, transposed)``: the layers of one
    pattern position and one name in block order (a leaf of its stacked
    ``blocks``), or one parameter (its ``tail``, ``embed``, ``final_norm``,
    ``lm_head``).  ``transposed`` for an ``nn.Linear``'s (out, in) weight,
    the reference's (in, out) matrix."""
    nblocks = layer_counts(cfg)[0]
    period = len(cfg.layer_pattern)
    groups = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        owner, _, _ = name.rpartition(".")
        linear = bool(owner) and isinstance(model.get_submodule(owner), torch.nn.Linear)
        parts = name.split(".")
        key = name
        if parts[0] == "layers" and int(parts[1]) < nblocks * period:
            key = (int(parts[1]) % period, ".".join(parts[2:]))
        groups.setdefault(key, ([], linear))[0].append(i)
    return list(groups.values())


def _whole_blocks(local: torch.Tensor, spec: tuple, mesh, block: int = 256) -> bool:
    """True where this rank's shard ``local`` of a leaf of storage spec
    ``spec`` holds whole ``block``s of the leaf's flat layout, in their
    order: the runs it makes in that layout (from its last sharded dim on)
    are multiples of the block, and so start on one.  True for a leaf that
    is not sharded (``mesh`` None: on one device)."""
    dims = [
        d for d, e in enumerate(spec)
        if mesh is not None and axis_size(mesh, entry_axes(e)) > 1
    ]
    if not dims:
        return True
    k = dims[-1]
    return local.shape[k] * math.prod(local.shape[k + 1 :]) % block == 0


def _compress(grads, errors, shardings, leaves):
    """``quantize_dequantize_psum_sim`` of the global gradients in the
    reference's leaves (``reference_leaves``), on their shards (module
    note); ``shardings`` None: whole parameters on one device."""
    if errors is None:
        errors = [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads
        ]
    new_grads, new_errors = list(grads), list(errors)
    for idx, transposed in leaves:
        sh = None if shardings is None else shardings[idx[0]]

        def ref(t):  # a port parameter's tensor in the reference's layout
            return t.t() if transposed else t

        def stack(ts, whole):
            return torch.stack([ref(unshard_tensor(t, sh) if whole else t) for t in ts])

        local = stack([grads[i] for i in idx], False)
        whole = sh is not None and not _whole_blocks(
            local, (None,) + (sh.spec[::-1] if transposed else sh.spec), sh.mesh
        )
        g = stack([grads[i] for i in idx], True) if whole else local
        (ng,), (ne,) = quantize_dequantize_psum_sim(
            [g], [stack([errors[i] for i in idx], whole)]
        )

        def back(t):  # a layer's slice of a reference leaf as its shard
            t = ref(t).contiguous()
            return shard_tensor(t, sh) if whole else t

        for j, i in enumerate(idx):
            new_grads[i], new_errors[i] = back(ng[j]), back(ne[j])
    return new_grads, new_errors


def train_step(
    model, opt_state, grad_errors, batch, *, cfg, tcfg: TrainConfig, mesh=None
):
    """(model, opt_state, grad_errors, metrics), the first two updated in
    place; metrics ``loss``, ``nll``, ``aux``, ``tokens``, ``grad_norm``,
    ``lr`` as float32 scalars on the device.  A non-finite loss applies
    nothing (see the module note).  On ``mesh`` every argument is this
    rank's shard and the metrics are the global batch's, the same on every
    rank."""
    shardings = None
    if mesh is None:
        grads, metrics = grads_fn(model, cfg, batch, tcfg)
    else:
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError("the model is not sharded on this mesh (shard_params)")
        shardings = param_shardings(model, cfg)
        with settings.fsdp_gather(mesh):
            grads, metrics = grads_fn(model, cfg, batch, tcfg)
        grads = reduce_grads(grads, model, cfg, mesh)
    new_errors = grad_errors
    if tcfg.compress_cross_pod:
        leaves = reference_leaves(model, cfg)
        grads, new_errors = _compress(grads, grad_errors, shardings, leaves)
    if not bool(torch.isfinite(metrics["loss"])):
        metrics.update(
            grad_norm=global_norm(grads, shardings),
            lr=lr_schedule(tcfg.optimizer, opt_state.step + 1),
        )
        return model, opt_state, grad_errors, metrics
    model, opt_state, opt_metrics = adamw_update(
        tcfg.optimizer, grads, opt_state, model, shardings
    )
    metrics.update(opt_metrics)
    return model, opt_state, new_errors, metrics


def make_train_step(
    cfg, mesh=None, tcfg: TrainConfig | None = None, with_embeds: bool = False
):
    """The step ``step(model, opt_state, grad_errors, batch)``: on one
    device without a mesh, else over this rank's shards (module note).
    ``with_embeds`` is the reference's signature and changes nothing here:
    its step is built for one input sharding, while this one places a batch
    of ``embeds`` as one of ``tokens`` (``sharding.shard_batch``)."""
    del with_embeds
    step = functools.partial(train_step, cfg=cfg, tcfg=tcfg or TrainConfig())
    return step if mesh is None else functools.partial(step, mesh=mesh)

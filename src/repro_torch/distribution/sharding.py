"""Sharding rules: how every parameter and batch maps onto the mesh.

Counterpart of ``repro.distribution.sharding``.  Axes (``launch.mesh``):
("data", "model") in a pod, and "pod" across pods.

* "data": the FSDP axis.  Parameters, gradients and optimizer states are
  sharded along d_model-like dims (ZeRO-3); each layer gathers its weights
  just in time (``models.shardspecs.gather_layer_params``).
* "model": the tensor and expert parallel axis: attention heads, FFN
  width, MoE experts, the vocabulary.
* "pod": pure data parallelism.  Parameters are replicated across pods and
  gradients summed across them (``training.train_step``).

One process a rank (``launch.mesh``), so a sharded tensor is this rank's
shard of it: a ``Sharding`` (the port's ``NamedSharding``: a mesh and a
spec, one entry a dim) says which.  A dim of size n over axes of k ranks
in all is cut into k equal runs, the rank at coordinate i along them
holding run i; k must divide n, as the reference's ``device_put`` asks.
``shard_params`` turns a whole model into this rank's shard in place, and
``gather_params`` gives the whole tensors back (checkpoints, tests).
"""

from __future__ import annotations

import dataclasses

import torch

from ..launch.mesh import all_gather, axis_group, axis_index, axis_size
from ..models.shardspecs import batch_axes, embed_spec, entry_axes, layer_specs
from ..models.transformer import block_spec


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's placement on ``mesh``: ``spec`` has one entry a dim,
    None (whole), an axis name or a tuple of names (in the mesh's order);
    ``()`` is a replicated tensor of any shape."""

    mesh: object
    spec: tuple


def param_specs(cfg) -> dict:
    """The storage spec of every parameter of ``init_model(cfg)``, by its
    name in ``model.named_parameters()``."""
    out = {}
    spec = block_spec(cfg)
    for i in range(cfg.num_layers):
        for name, s in layer_specs(cfg, *spec[i % len(spec)]).items():
            out[f"layers.{i}.{name}"] = s
    out["final_norm"] = (None,)
    # vocab-parallel embedding, column-parallel head: no "data" conflict
    # with the batch (models/shardspecs.py); where the vocabulary does not
    # divide the production TP degree (mamba2: 50280) both shard d_model
    # over "model" instead.
    out["embed"] = embed_spec(cfg)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = embed_spec(cfg)
    return out


def data_specs(cfg, mesh, shape_kind: str, with_embeds: bool) -> dict:
    """The batch's specs: its rows over the DP axes (one axis by its name,
    as a ``PartitionSpec`` reads a tuple of one)."""
    dp = batch_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    specs = {}
    if with_embeds:
        specs["embeds"] = (dp, None, None)
    else:
        specs["tokens"] = (dp, None)
    if shape_kind == "train":
        specs["targets"] = (dp, None)
    return specs


def shardings_of(specs, mesh):
    """``specs`` (a spec, or a dict, list or tuple of them; None stays
    None) with each spec as a ``Sharding`` on ``mesh``."""
    if isinstance(specs, dict):
        return {k: shardings_of(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [shardings_of(v, mesh) for v in specs]
    if specs is None:
        return None
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(shardings_of(v, mesh) for v in specs))
    return Sharding(mesh, tuple(specs))


def shard_tensor(t: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (a contiguous copy; ``t``
    itself for None or a spec that shards nothing)."""
    if sharding is None or not any(entry_axes(e) for e in sharding.spec):
        return t
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    out = t
    for dim, entry in enumerate(spec):
        names = entry_axes(entry)
        if not names:
            continue
        k = axis_size(mesh, names)
        if t.shape[dim] % k:
            raise ValueError(
                f"dim {dim} of shape {tuple(t.shape)} does not divide over "
                f"{names} ({k} ranks)"
            )
        n = t.shape[dim] // k
        out = out.narrow(dim, axis_index(mesh, names) * n, n)
    return out if out is t else out.contiguous()


def unshard_tensor(t: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` (``all_gather`` over
    each sharded dim's axes); every rank of the mesh must call it."""
    if sharding is None:
        return t
    for dim, entry in enumerate(sharding.spec):
        names = entry_axes(entry)
        group = axis_group(sharding.mesh, names) if names else None
        if group is not None:
            t = torch.cat(all_gather(t, group), dim=dim)
    return t


def constrain(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """A replicated ``x`` as this rank's shard of ``spec`` (the local form
    of the reference's sharding constraint)."""
    return shard_tensor(x, Sharding(mesh, tuple(spec)))


def param_shardings(model, cfg) -> list:
    """The ``Sharding`` of each parameter of a sharded model, in its
    parameter order."""
    specs = param_specs(cfg)
    return [Sharding(model.mesh, specs[n]) for n, _ in model.named_parameters()]


def shard_params(model, cfg, mesh):
    """Turn the whole model ``model`` into this rank's shard of it, in place:
    every parameter becomes its shard of ``param_specs(cfg)`` on ``mesh``
    (the whole tensor is freed), and the model is marked as computing on
    ``mesh`` (``models.settings.fsdp_gather``).  With
    ``convert.lm_params_from_numpy`` this carries the reference's weights
    onto the mesh.  Returns the model."""
    specs = param_specs(cfg)
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(specs):
        raise ValueError(f"parameters {sorted(set(names) ^ set(specs))} lack a spec")
    with torch.no_grad():
        for name in names:
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            p = module._parameters[leaf]
            local = shard_tensor(p.detach(), Sharding(mesh, specs[name]))
            module._parameters[leaf] = torch.nn.Parameter(
                local, requires_grad=p.requires_grad
            )
    model.mesh = mesh
    return model


def gather_params(model, cfg) -> dict:
    """The whole tensor of every parameter of a sharded model, by name, on
    every rank (collective)."""
    mesh = getattr(model, "mesh", None)
    specs = param_specs(cfg)
    with torch.no_grad():
        return {
            n: unshard_tensor(p.detach(), Sharding(mesh, specs[n]) if mesh else None)
            for n, p in model.named_parameters()
        }


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch (dict of (B, ...) arrays or
    tensors; every rank passes the same).  The batch is split over the DP
    axes within each of ``microbatches`` consecutive blocks of B /
    microbatches rows, as the reference's sharded microbatch scan splits
    it: the rank's rows are microbatch-major, so ``train_step``'s split of
    them gives each microbatch's shard.  B must divide over both."""
    dp = batch_axes(mesh)
    k, i = axis_size(mesh, dp), axis_index(mesh, dp)
    out = {}
    for key, v in batch.items():
        b = v.shape[0]
        if b % (k * microbatches):
            raise ValueError(
                f"a batch of {b} rows does not divide into {microbatches} "
                f"microbatches over {k} data-parallel ranks {dp}"
            )
        n = b // (k * microbatches)
        rows = v.reshape(microbatches, k, n, *v.shape[1:])[:, i]
        out[key] = rows.reshape(microbatches * n, *v.shape[1:])
    return out


def gather_logits(logits: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The whole vocabulary's logits from this rank's slice (collective
    over "model"); whole logits as they are."""
    from ..models.shardspecs import vocab_parallel

    group = axis_group(mesh, "model")
    if group is None or not vocab_parallel(cfg):
        return logits
    return torch.cat(all_gather(logits.detach(), group), dim=-1)

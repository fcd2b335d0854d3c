"""Generic decoder stack of the ten LM architectures.

Counterpart of ``repro.models.transformer``.  A model is ``num_layers``
layers cycling through the config's ``layer_pattern``, pre-norm with
residuals.  Layer kinds:

* ``attn``, ``swa``, ``local``: global, sliding-window or local attention,
  then an MLP, or a mixture of experts where ``block_spec`` says so;
* ``ssd``: the Mamba-2 mixer, which is the whole block (no MLP);
* ``rglru``: the RG-LRU recurrent block, then an MLP.

The reference scans blocks of stacked parameters; here the layers are an
``nn.ModuleList`` walked in order, so caches are a flat list with one
entry a layer: a ring-buffer KV cache for attention, the (conv, SSM) or
(conv, h) state for the recurrent kinds.  With ``remat=True`` (training)
each block, one period of ``cfg.layer_pattern`` (the reference's unit of
``jax.checkpoint``), runs under ``torch.utils.checkpoint``; the tail layers
are not wrapped, as in the reference.

On a mesh (``settings.fsdp_gather(mesh)``, the model sharded by
``distribution.sharding.shard_params``) each rank holds its shard of every
weight and its data-parallel rows of the batch.  ``_apply_layer`` gathers a
layer's "data" factor just in time and computes tensor-parallel on the
"model" factor (``shardspecs``); the embedding is vocab-parallel (a masked
lookup, then the sum over "model") and the head column-parallel, so the
logits come back as this rank's slice of the vocabulary
(``sharding.gather_logits`` joins them).  Where ``PRODUCTION_TP`` does not
divide the vocabulary (mamba2's 50280) the table is gathered whole and the
logits are whole.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..launch.mesh import copy_to_region, reduce_from_region
from . import settings
from .attention import Attention, init_attention_cache, multihead_attention
from .common import (
    apply_linear,
    dtype_of,
    embed_init,
    linear,
    rms_norm,
    take_embedding,
)
from .mlp import MLP, mlp
from .moe import MoE, moe_block
from .shardspecs import (
    embed_spec,
    gather_axes,
    gather_layer_params,
    model_parallel,
    vocab_parallel,
)
from .rglru import RGLRU, init_rglru_state, rglru_block
from .ssm import SSM, init_ssm_state, ssm_block

ATTN_KINDS = ("attn", "swa", "local")
RECURRENT_KINDS = ("ssd", "rglru")


def block_spec(cfg):
    """((kind, use_moe), ...): one entry per layer of a pattern period."""
    spec = []
    for i, kind in enumerate(cfg.layer_pattern):
        use_moe = (
            bool(cfg.moe)
            and kind in ATTN_KINDS
            and (i % cfg.moe_every == cfg.moe_every - 1)
        )
        spec.append((kind, use_moe))
    return tuple(spec)


def layer_counts(cfg):
    """(full pattern periods, remaining layers)."""
    period = len(cfg.layer_pattern)
    nblocks = cfg.num_layers // period
    return nblocks, cfg.num_layers - nblocks * period


def param_count(cfg) -> int:
    """Parameters of ``init_model(cfg)``, counted from the config's shapes
    alone (every matrix, norm scale, bias and vector)."""
    d, hd, v = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    attn = d * hd * (h + 2 * kv) + h * hd * d + (2 * hd if cfg.qk_norm else 0)

    def mlp(kind):
        return d * f * (3 if kind == "swiglu" else 2)

    total = v * d + d + (0 if cfg.tie_embeddings else d * v)
    spec = block_spec(cfg)
    for i in range(cfg.num_layers):
        kind, use_moe = spec[i % len(spec)]
        total += d  # norm1
        if kind == "ssd":
            d_in = cfg.ssm_expand * d
            heads = d_in // cfg.ssm_head_dim
            conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
            total += d * (d_in + conv_ch + heads) + d_in * d  # w_in, w_out
            total += (cfg.ssm_conv_width + 1) * conv_ch + 3 * heads + d_in
            continue
        total += d  # norm2
        if kind == "rglru":
            lw = cfg.lru_width or d
            # w_x, w_gate, w_out; w_a, w_i; conv_w; conv_b, b_a, b_i, lam
            total += 3 * d * lw + 2 * lw * lw + 4 * lw + 4 * lw
        else:
            total += attn
        if use_moe:
            e = cfg.num_experts
            total += d * e + e * mlp("swiglu")
            total += mlp("swiglu") if cfg.moe_shared_expert else 0
        else:
            total += mlp(cfg.mlp_kind)
    return total


def _window(cfg, kind: str) -> int:
    return cfg.window if kind in ("swa", "local") else 0


class Layer(nn.Module):
    """One layer, holding what the reference's layer dict holds: ``norm1``
    and the mixer (``attn``, ``ssm`` or ``rglru``); for the attention and
    rglru kinds also ``norm2`` and the feed-forward (``mlp``, or ``moe``
    on an attention layer that ``block_spec`` marks)."""

    def __init__(self, cfg, kind: str, use_moe: bool, dtype, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind, self.use_moe = kind, use_moe

        def norm():
            return nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype, device=device))

        self.norm1 = norm()
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, dtype, **kw)
        elif kind == "ssd":
            self.ssm = SSM(cfg, dtype, **kw)
        elif kind == "rglru":
            self.rglru = RGLRU(cfg, dtype, **kw)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if kind != "ssd":
            self.norm2 = norm()
            if use_moe:
                self.moe = MoE(cfg, dtype, **kw)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, **kw)


class Model(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` and, without tied
    embeddings, ``lm_head`` (d -> V)."""

    def __init__(self, cfg, *, generator, device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        kw = dict(generator=generator, device=device)
        spec = block_spec(cfg)
        self.layers = nn.ModuleList(
            Layer(cfg, *spec[i % len(spec)], dtype, **kw)
            for i in range(cfg.num_layers)
        )
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=dtype, device=device)
        )
        self.embed = nn.Parameter(
            embed_init((cfg.vocab_size, cfg.d_model), dtype, **kw)
        )
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = linear(cfg.d_model, cfg.vocab_size, dtype, **kw)


def init_model(
    cfg, *, generator: torch.Generator | None = None, device=None
) -> Model:
    """The model of an ``ArchConfig`` with random weights, in ``cfg.dtype``.

    ``device`` defaults to the CUDA device (raising without one); the
    weights are drawn from ``generator``, which must lie on that device
    (default: a new one seeded with 0).
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return Model(cfg, generator=generator, device=dev)


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    caches: Any


def _apply_layer(layer: Layer, x, cfg, *, attn_impl, positions, cache, dropless):
    """(x, the layer's new cache, its MoE aux loss or None)."""
    mesh = settings.FSDP_GATHER_MESH
    w, tp = layer, None
    if mesh is not None:
        # ZeRO-3: the layer's FSDP-sharded weights gathered just in time
        w = gather_layer_params(layer, cfg, layer.kind, layer.use_moe, mesh)
        tp = model_parallel(mesh)
    h_in = rms_norm(x, w.norm1, cfg.norm_eps)
    if layer.kind == "ssd":
        h, new_cache = ssm_block(w.ssm, h_in, cfg, state=cache)
        return x + h, new_cache, None
    if layer.kind == "rglru":
        h, new_cache = rglru_block(w.rglru, h_in, cfg, state=cache)
    else:
        h, new_cache = multihead_attention(
            w.attn,
            h_in,
            cfg,
            layer_window=_window(cfg, layer.kind),
            impl=attn_impl,
            positions=positions,
            cache=cache,
            tp=tp,
        )
    x = x + h
    h2 = rms_norm(x, w.norm2, cfg.norm_eps)
    aux = None
    if layer.use_moe:
        h2, aux = moe_block(w.moe, h2, cfg, dropless=dropless)
    else:
        h2 = mlp(w.mlp, h2, cfg.mlp_kind, tp)
    return x + h2, new_cache, aux


def _on_mesh(model):
    """The mesh the model computes on (None on one device); a sharded
    model runs only under its own mesh."""
    mesh = settings.FSDP_GATHER_MESH
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError(
            "a model sharded on a mesh runs under models.settings.fsdp_gather(mesh) "
            "of that mesh, and a whole model under none"
        )
    return mesh


def _embed(model, cfg, tokens, mesh):
    """The embedding lookup: vocab-parallel on a mesh (module note)."""
    if mesh is None:
        return take_embedding(model.embed, tokens)
    if not vocab_parallel(cfg):
        table = gather_axes(model.embed, embed_spec(cfg), mesh, ("model",), False)
        return take_embedding(table, tokens)
    tp = model_parallel(mesh)
    rows = model.embed.shape[0]
    local = tokens - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = take_embedding(model.embed, torch.where(inside, local, 0))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(inside[..., None], x, zero)
    return reduce_from_region(x, tp.group)


def _head(model, cfg, x, mesh):
    """The logits: this rank's vocabulary slice where vocab-parallel."""
    w = model.embed if model.lm_head is None else model.lm_head.weight
    if mesh is None:
        return apply_linear(x, w)
    if not vocab_parallel(cfg):
        return apply_linear(x, gather_axes(w, embed_spec(cfg), mesh, ("model",), False))
    return apply_linear(copy_to_region(x, model_parallel(mesh).group), w)


def _apply_layers(layers, x, aux, cfg, caches, **kw):
    """Layers in order, each with its cache (``caches`` None: cacheless):
    (x, aux plus their MoE aux losses, the new caches or None).  ``kw``:
    ``_apply_layer``'s attn_impl, positions and dropless."""
    new_caches = None if caches is None else []
    for layer, cache in zip(
        layers, [None] * len(layers) if caches is None else caches, strict=True
    ):
        x, nc, layer_aux = _apply_layer(layer, x, cfg, cache=cache, **kw)
        if layer_aux is not None:
            aux = aux + layer_aux
        if caches is not None:
            new_caches.append(nc)
    return x, aux, new_caches


def _refuse_recurrent_continuation(cfg, positions, s: int) -> None:
    """A cached call of several tokens that does not start at position 0 on
    a model with ssd or rglru layers.  Their blocks, as the reference's,
    restart the recurrence from zero whenever a call has more than one
    token, so such a call would return wrong logits (the reference's
    recurrent prefill fault, ROADMAP Queue 3)."""
    if s > 1 and any(k in RECURRENT_KINDS for k in cfg.layer_pattern):
        if bool((positions[..., 0] != 0).any()):
            raise ValueError(
                f"a cached call of {s} tokens after position 0 on a model with "
                "ssd or rglru layers: their blocks restart the recurrence from a "
                "zero state whenever a call has more than one token (the "
                "reference's recurrent prefill fault, ROADMAP Queue 3); prefill "
                "from position 0, then decode one token a call"
            )


def forward(
    model: Model,
    cfg,
    tokens=None,
    embeds=None,
    positions=None,
    *,
    attn_impl: str = "naive",
    remat: bool = False,
    caches=None,
    dropless: bool | None = None,
):
    """Prefill or scoring forward.  tokens (B, S) integers or embeds
    (B, S, d), on the model's device.

    With ``caches`` (``init_caches``) the per-layer caches are filled (the
    attention caches in place) and returned.  ``dropless`` steers MoE
    dispatch; the default (None: ``caches is not None``) routes the cached
    serving paths without capacity drops and every cacheless forward with
    them, as the reference.  ``aux_loss`` is the MoE layers' router loss
    summed (0 without MoE).  ``remat=True`` recomputes each block's
    activations in the backward pass instead of keeping them (the values
    are the same: MoE dispatch is deterministic, so the recompute routes
    the same tokens); a cached call cannot take it.  On a mesh (module
    note) ``tokens``/``embeds`` are this rank's batch rows and the logits
    its slice of the vocabulary; no cache.
    """
    if remat and caches is not None:
        raise ValueError("remat=True is for training; a cached call cannot take it")
    mesh = _on_mesh(model)
    if mesh is not None and caches is not None:
        raise ValueError("a cached call does not run on a mesh")
    if dropless is None:
        dropless = caches is not None
    dev = model.embed.device
    if embeds is None:
        x = _embed(model, cfg, torch.as_tensor(tokens, device=dev), mesh)
    else:
        x = embeds.to(dtype_of(cfg.dtype))
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    kw = dict(attn_impl=attn_impl, positions=positions, dropless=dropless)
    if caches is not None:
        _refuse_recurrent_continuation(cfg, positions, s)
    layers = list(model.layers)
    period = len(cfg.layer_pattern)
    nblocks = layer_counts(cfg)[0] if remat else 0
    for b in range(nblocks):
        block = layers[b * period : (b + 1) * period]
        x, aux, _ = checkpoint(
            _apply_layers, block, x, aux, cfg, None, use_reentrant=False, **kw
        )
    x, aux, new_caches = _apply_layers(
        layers[nblocks * period :], x, aux, cfg, caches, **kw
    )
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return ForwardResult(_head(model, cfg, x, mesh), aux, new_caches)


def decode_step(
    model: Model,
    cfg,
    caches,
    tokens=None,
    embeds=None,
    pos=None,
    *,
    attn_impl: str = "naive",
):
    """One-token serve step.  tokens: (B,); pos: the global position of
    this token.  Returns (logits (B, V), caches)."""
    dev = model.embed.device
    if embeds is None:
        x = take_embedding(model.embed, torch.as_tensor(tokens, device=dev))
        x = x[:, None, :]
    else:
        x = embeds[:, None, :].to(dtype_of(cfg.dtype))
    positions = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(1, 1)
    out = forward(
        model, cfg, embeds=x, positions=positions, attn_impl=attn_impl, caches=caches
    )
    return out.logits[:, 0], out.caches


def init_caches(cfg, batch: int, max_len: int, *, device=None):
    """One cache a layer: a ring-buffer KV cache (``init_attention_cache``)
    for attention, the zero (conv, SSM) state for ``ssd`` and (conv, h) for
    ``rglru``."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def layer_cache(kind):
        if kind == "ssd":
            return init_ssm_state(cfg, batch, dtype, device=dev)
        if kind == "rglru":
            return init_rglru_state(cfg, batch, dtype, device=dev)
        return init_attention_cache(
            cfg, batch, max_len, _window(cfg, kind), dtype, device=dev
        )

    return [layer_cache(cfg.layer_kind(i)) for i in range(cfg.num_layers)]

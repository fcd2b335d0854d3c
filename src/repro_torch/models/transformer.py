"""Decoder stack of the dense, attention-only architectures.

Counterpart of ``repro.models.transformer``.  A model is ``num_layers``
layers cycling through the config's ``layer_pattern``; each layer is
attention (``attn`` global, ``swa`` sliding window, ``local`` windowed)
plus an MLP, pre-norm with residuals.  The reference scans blocks of
stacked parameters; here the layers are an ``nn.ModuleList`` walked in
order, so caches are a flat list with one entry a layer.

The mixture-of-experts, SSM (``ssd``) and RG-LRU (``rglru``) layers, the
modality frontends and rematerialisation (training) are not ported yet
(ROADMAP Queue 1 item 6, the rest of the LM substrate): a config or call
that needs them raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention, init_attention_cache, multihead_attention
from .common import dtype_of, embed_init, linear, rms_norm, take_embedding
from .mlp import MLP

ATTN_KINDS = ("attn", "swa", "local")
_NOT_PORTED = (
    "not ported yet (ROADMAP Queue 1 item 6, the rest of the LM substrate)"
)


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


def _check_supported(cfg) -> None:
    for kind, use_moe in block_spec(cfg):
        if kind not in ATTN_KINDS:
            raise ValueError(f"layer kind {kind!r} is {_NOT_PORTED}")
        if use_moe:
            raise ValueError(f"mixture-of-experts layers are {_NOT_PORTED}")
    if cfg.frontend != "none":
        raise ValueError(f"frontend {cfg.frontend!r} is {_NOT_PORTED}")


def _window(cfg, kind: str) -> int:
    return cfg.window if kind in ("swa", "local") else 0


class Layer(nn.Module):
    """norm1 -> attention -> residual, norm2 -> MLP -> residual."""

    def __init__(self, cfg, kind: str, dtype, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.norm1 = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=dtype, device=device)
        )
        self.attn = Attention(cfg, dtype, **kw)
        self.norm2 = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=dtype, device=device)
        )
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, **kw)


class Model(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` and, without tied
    embeddings, ``lm_head`` (d -> V)."""

    def __init__(self, cfg, *, generator, device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        kw = dict(generator=generator, device=device)
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.layer_kind(i), dtype, **kw) for i in range(cfg.num_layers)
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
    _check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return Model(cfg, generator=generator, device=dev)


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    caches: Any


def _apply_layer(layer: Layer, x, cfg, *, attn_impl, positions, cache):
    h, new_cache = multihead_attention(
        layer.attn,
        rms_norm(x, layer.norm1, cfg.norm_eps),
        cfg,
        layer_window=_window(cfg, layer.kind),
        impl=attn_impl,
        positions=positions,
        cache=cache,
    )
    x = x + h
    x = x + layer.mlp(rms_norm(x, layer.norm2, cfg.norm_eps))
    return x, new_cache


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

    With ``caches`` (``init_caches``) the per-layer caches are filled in
    place and returned.  ``dropless`` steers MoE dispatch in the reference
    and has nothing to steer here; ``remat`` (training) is not ported.
    """
    if remat:
        raise ValueError(f"remat=True (training) is {_NOT_PORTED}")
    dev = model.embed.device
    if embeds is None:
        x = take_embedding(model.embed, torch.as_tensor(tokens, device=dev))
    else:
        x = embeds.to(dtype_of(cfg.dtype))
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    new_caches = [] if caches is not None else None
    for i, layer in enumerate(model.layers):
        cache = None if caches is None else caches[i]
        x, nc = _apply_layer(
            layer, x, cfg, attn_impl=attn_impl, positions=positions, cache=cache
        )
        if caches is not None:
            new_caches.append(nc)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if model.lm_head is None:
        logits = x @ model.embed.T
    else:
        logits = model.lm_head(x)
    aux = torch.zeros((), dtype=torch.float32, device=dev)  # no MoE layer
    return ForwardResult(logits, aux, new_caches)


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
    """One ring-buffer KV cache a layer (``init_attention_cache``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [
        init_attention_cache(
            cfg, batch, max_len, _window(cfg, cfg.layer_kind(i)), dtype, device=dev
        )
        for i in range(cfg.num_layers)
    ]

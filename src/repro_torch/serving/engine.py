"""Batched serving engine: prefill, then greedy decode over the caches.

Counterpart of ``repro.serving.engine``.  The reference jit-compiles its
prefill and serve step; here they are plain functions run under
``torch.inference_mode()``.  ``ServeState.caches`` holds one cache a layer:
a ring-buffer KV cache for attention (O(window) for windowed layers) and
the O(1) recurrent state of an ssd or rglru layer.  With a cache, attention
is the plain masked path (``models.attention``), as in the reference, so
the engine launches no flash kernel; the prefill and scoring forward
without caches does.  The cached paths route MoE layers without capacity
drops (``forward``'s ``dropless`` default).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..device import as_tensor
from ..models.transformer import decode_step, forward, init_caches


class ServeState(NamedTuple):
    caches: Any  # one cache a layer (models.transformer.init_caches)
    pos: int  # next position to write (global stream index)
    last_tokens: torch.Tensor  # (B,) most recent token of each sequence


def make_serve_fns(cfg, max_len: int, attn_impl: str = "naive"):
    """(prefill, serve_step): prefill(model, tokens (B, S)) and
    serve_step(model, state) each return (ServeState, last logits (B, V)).
    The KV caches are updated in place; recurrent states are replaced."""

    @torch.inference_mode()
    def prefill(model, tokens):
        b, s = tokens.shape
        dev = model.embed.device
        caches = init_caches(cfg, b, max_len, device=dev)
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        out = forward(
            model,
            cfg,
            tokens=tokens,
            positions=positions,
            attn_impl=attn_impl,
            caches=caches,
        )
        logits = out.logits[:, -1]
        return ServeState(out.caches, s, logits.argmax(dim=-1)), logits

    @torch.inference_mode()
    def serve_step(model, state: ServeState):
        logits, caches = decode_step(
            model,
            cfg,
            state.caches,
            tokens=state.last_tokens,
            pos=state.pos,
            attn_impl=attn_impl,
        )
        return ServeState(caches, state.pos + 1, logits.argmax(dim=-1)), logits

    return prefill, serve_step


def generate(
    model,
    cfg,
    prompt_tokens,
    steps: int,
    max_len: int = 0,
    attn_impl: str = "naive",
    *,
    device=None,
):
    """Greedy generation: returns the (B, steps) new tokens.

    ``prompt_tokens`` (B, S): a tensor stays on its device; anything else
    goes to ``device`` (default the CUDA device, raising without one).
    """
    tokens = as_tensor(prompt_tokens, device=device, dtype=torch.long)
    b, s = tokens.shape
    if max_len <= 0:
        max_len = s + steps
    prefill, serve_step = make_serve_fns(cfg, max_len, attn_impl)
    state, _ = prefill(model, tokens)
    outs = []
    for _ in range(steps):
        outs.append(state.last_tokens)
        state, _ = serve_step(model, state)
    return torch.stack(outs, dim=1)

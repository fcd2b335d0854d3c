"""Attention layer: GQA/MQA/MHA, RoPE, qk-norm, sliding/local windows.

Counterpart of ``repro.models.attention``.  Three interchangeable inner
implementations, chosen by ``impl``:

* ``naive``   materializes the (Sq, Skv) score matrix;
* ``chunked`` the online softmax over KV chunks in plain PyTorch;
* ``kernel``  the hand-written flash kernel through ``kernels.ops.attention``
  (the reference's ``pallas``): on a CUDA tensor ``csrc/flash_attention.cu``,
  on a CPU tensor its plain version.

With a cache (prefill into a cache, decode) attention is the explicit-position
masked path over the ring buffer, whatever ``impl`` says, as in the
reference.  Caches are updated in place.

On a mesh (``tp``, a ``shardspecs.ModelParallel``) the layer is
tensor-parallel over "model": this rank's query heads, and its KV heads
(GQA groups kept whole), or K and V whole where the axis does not divide
the KV heads (``shardspecs.kv_whole``); ``wo`` row-parallel, then the sum
over the axis.  ``impl="kernel"`` runs the flash kernel on this rank's
heads.  A cached call takes no mesh.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops as kops
from ..launch.mesh import copy_to_region, reduce_from_region
from .common import apply_linear, apply_rope, linear, rms_norm

_MASKED = -1e30  # the chunked path's masked score, as the reference's


class Attention(nn.Module):
    """The weights of ``AttentionParams``: ``wq``, ``wk``, ``wv``, ``wo``
    (bias-free linears) and the qk-norm scales ``q_norm``, ``k_norm`` (None
    without qk-norm)."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(generator=generator, device=device)
        self.wq = linear(d, cfg.num_heads * hd, dtype, **kw)
        self.wk = linear(d, cfg.num_kv_heads * hd, dtype, **kw)
        self.wv = linear(d, cfg.num_kv_heads * hd, dtype, **kw)
        self.wo = linear(cfg.num_heads * hd, d, dtype, **kw)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(hd, dtype=dtype, device=device))
            self.k_norm = nn.Parameter(torch.zeros(hd, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Inner attention implementations (q: (B, S, H, hd), k/v: (B, Skv, KV, hd))
# ---------------------------------------------------------------------------


def _naive_attention(
    q, k, v, *, causal, window, kv_positions=None, q_positions=None
):
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    group = h // kvh
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, group, hd) * float(hd) ** -0.5
    scores = torch.einsum("bqmgd,bkmd->bmgqk", qf, k.float())
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev) + (skv - sq)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)
    qpos = torch.as_tensor(q_positions, device=dev)
    kpos = torch.as_tensor(kv_positions, device=dev)
    qpos = (qpos[None] if qpos.dim() == 1 else qpos).expand(b, sq)
    kpos = (kpos[None] if kpos.dim() == 1 else kpos).expand(b, skv)
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[:, None, :] <= qpos[:, :, None]
    if window and window > 0:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    mask &= (kpos >= 0)[:, None, :]  # ring-buffer slots not yet filled
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.masked_fill(~torch.isfinite(scores).any(-1, keepdim=True), 0.0)
    out = torch.einsum("bmgqk,bkmd->bqmgd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _chunked_attention(q, k, v, *, causal, window, chunk: int = 1024):
    """Online softmax over KV chunks (the flash algorithm in plain PyTorch)."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    group = h // kvh
    nchunks = max(skv // chunk, 1)
    chunk = skv // nchunks
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, group, hd) * float(hd) ** -0.5
    kc = k.float().reshape(b, nchunks, chunk, kvh, hd)
    vc = v.float().reshape(b, nchunks, chunk, kvh, hd)
    qpos = torch.arange(sq, device=dev) + (skv - sq)
    acc = torch.zeros((b, kvh, group, sq, hd), device=dev)
    m = torch.full((b, kvh, group, sq, 1), _MASKED, device=dev)
    lsum = torch.zeros((b, kvh, group, sq, 1), device=dev)
    for ki in range(nchunks):
        kpos = ki * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqmgd,bkmd->bmgqk", qf, kc[:, ki])
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window and window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, _MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        lsum = corr * lsum + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bmgqk,bkmd->bmgqd", p, vc[:, ki])
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)
    return out.movedim(3, 1).reshape(b, sq, h, hd).to(q.dtype)


def _kernel_attention(q, k, v, *, causal, window):
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    qf = q.movedim(2, 1).reshape(b * h, sq, hd)
    kf = k.movedim(2, 1).reshape(b * kvh, skv, hd)
    vf = v.movedim(2, 1).reshape(b * kvh, skv, hd)
    out = kops.attention(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, sq, hd).movedim(1, 2)


def init_attention_cache(
    cfg, batch: int, max_len: int, layer_window: int, dtype, *, device
):
    """Unified (ring-buffer) KV cache.

    Global attention: slots == max_len (the ring is a dense cache).  Windowed
    attention: slots == window, so memory stays O(window) however long the
    stream runs.
    """
    slots = min(layer_window, max_len) if layer_window else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    return dict(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        # -1: the slot is empty (masked)
        kpos=torch.full((slots,), -1, dtype=torch.int32, device=device),
    )


def _cache_insert(cache, k, v, positions):
    """Insert s new steps at slots positions % slots, in place.
    positions: (1, s).

    One call may insert at most as many steps as the cache has slots.  The
    reference wraps a longer insert around the ring, so a windowed prefill
    longer than the window overwrites keys that earlier queries of the same
    prefill still need and returns wrong logits (ROADMAP Queue 3); the port
    refuses it instead, and so never writes two steps to one slot.
    """
    slots = cache["k"].shape[1]
    pos = positions[0].to(torch.long)
    if pos.shape[0] > slots:
        raise ValueError(
            f"one call inserts {pos.shape[0]} steps into a cache of {slots} "
            "slots: later steps would overwrite keys that earlier queries of "
            "the same call attend to (the reference's windowed ring-cache "
            f"prefill fault, ROADMAP Queue 3); prefill at most {slots} tokens "
            "into this cache"
        )
    slot = pos % slots
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cache["kpos"].index_copy_(0, slot, pos.to(torch.int32))
    return cache


def _local_heads(cfg, tp):
    """(query heads, KV heads computed, KV heads kept) on this rank and the
    first KV head it keeps of those computed."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if tp is None:
        return h, kvh, kvh, 0
    if h % tp.size:
        raise ValueError(f"{tp.size} model-parallel ranks do not divide {h} heads")
    hl = h // tp.size
    if kvh % tp.size == 0:
        return hl, kvh // tp.size, kvh // tp.size, 0
    group = h // kvh  # K and V whole: keep the one KV head of this rank's group
    if group % hl:
        raise ValueError(
            f"{tp.size} model-parallel ranks split the query heads of a GQA group "
            f"of {group} across KV heads ({h} heads, {kvh} KV heads)"
        )
    return hl, kvh, 1, tp.rank * hl // group


def multihead_attention(
    params: Attention,
    x,
    cfg,
    *,
    layer_window: int,
    impl: str = "naive",
    positions=None,
    cache=None,
    tp=None,
):
    """Full attention layer.  x: (B, S, d).

    With ``cache`` (decode, or prefill into a cache): the new K/V are
    inserted at their ring slots and attention runs over the cache with
    explicit positions.  ``tp`` computes this rank's heads (module note).
    Returns (out, the updated cache or None).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv_all, kvh, kv0 = _local_heads(cfg, tp)
    group = None if tp is None else tp.group
    if cache is not None and group is not None:
        raise ValueError("a cached call does not run on a mesh")
    x = copy_to_region(x, group)
    q = apply_linear(x, params.wq).reshape(b, s, h, hd)
    k = apply_linear(x, params.wk).reshape(b, s, kv_all, hd)
    v = apply_linear(x, params.wv).reshape(b, s, kv_all, hd)
    if kvh != kv_all:
        k, v = k[:, :, kv0 : kv0 + kvh], v[:, :, kv0 : kv0 + kvh]
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        new_cache = _cache_insert(cache, k, v, positions)
        out = _naive_attention(
            q,
            new_cache["k"],
            new_cache["v"],
            causal=True,
            window=layer_window,
            kv_positions=new_cache["kpos"],
            q_positions=positions,
        )
    elif impl == "chunked":
        out = _chunked_attention(q, k, v, causal=True, window=layer_window)
    elif impl == "kernel":
        out = _kernel_attention(q, k, v, causal=True, window=layer_window)
    elif impl == "naive":
        out = _naive_attention(q, k, v, causal=True, window=layer_window)
    else:
        raise ValueError(
            f"attention impl must be naive, chunked or kernel, got {impl!r}"
        )
    out = apply_linear(out.reshape(b, s, h * hd), params.wo)
    return reduce_from_region(out, group), new_cache

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
tensor-parallel over "model": this rank's query heads and the KV heads
they read (``head_split``); ``wo`` row-parallel, then the sum over the
axis.  Where the axis does not divide the query heads (llama4's 40 and
musicgen's 24 on 16) a rank takes ceil(H / size) of them in order and the
last ranks fewer or none, the padding of GSPMD's uneven split; its rows of
``wq``, ``wo`` (and of ``wk``, ``wv`` where the axis does not divide the KV
heads) are taken from the whole weights (``shardspecs.gather_layer_params``).
``impl="kernel"`` runs the flash kernel on this rank's heads.  A cached call
on a mesh keeps the KV heads its query heads read in a cache of this rank's
batch rows (``init_attention_cache``'s ``kv_heads``); the
reference's dry-run instead keeps K/V's heads whole on every "model" rank
(a difference by design, ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

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
    cfg, batch: int, max_len: int, layer_window: int, dtype, *, device, kv_heads=None
):
    """Unified (ring-buffer) KV cache of ``kv_heads`` heads (default: all).

    Global attention: slots == max_len (the ring is a dense cache).  Windowed
    attention: slots == window, so memory stays O(window) however long the
    stream runs.
    """
    slots = min(layer_window, max_len) if layer_window else max_len
    kvh = cfg.num_kv_heads if kv_heads is None else kv_heads
    shape = (batch, slots, kvh, cfg.resolved_head_dim)
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


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """A rank's share of the heads on the "model" axis: query heads
    [q0, q0 + q) and the KV heads [kv0, kv0 + kv) they read.  ``q_whole``:
    ``wq`` and ``wo`` come whole (an uneven split) and the layer takes its
    rows of them; ``kv_whole``: ``wk`` and ``wv`` come whole, K and V are
    computed whole and the layer keeps its heads of them."""

    q0: int
    q: int
    kv0: int
    kv: int
    q_whole: bool = False
    kv_whole: bool = False


def head_split(cfg, tp) -> HeadSplit:
    """This rank's heads: ceil(H / size) query heads a rank in order, as
    GSPMD pads an uneven split (llama4's 40 on 16: 3 a rank on ranks 0-12,
    1 on rank 13, none on 14 and 15), and the KV heads they read."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if tp is None:
        return HeadSplit(0, h, 0, kvh)
    per = -(-h // tp.size)
    q0 = min(tp.rank * per, h)
    q = min(q0 + per, h) - q0
    group = h // kvh
    kv0 = q0 // group if q else 0
    kv = (q0 + q - 1) // group + 1 - kv0 if q else 0
    q_whole = h % tp.size != 0
    return HeadSplit(q0, q, kv0, kv, q_whole, q_whole or kvh % tp.size != 0)


def cache_kv_heads(cfg, tp) -> int:
    """The KV heads a rank's cache holds (all without a mesh)."""
    return head_split(cfg, tp).kv


def _kv_index(sp: HeadSplit, group: int):
    """None where the rank's query heads read its KV heads in equal groups
    in order (the inner attentions' GQA layout); else, for each query head,
    the KV head it reads among the rank's."""
    idx = [i // group - sp.kv0 for i in range(sp.q0, sp.q0 + sp.q)]
    if sp.q % sp.kv == 0 and idx == [j // (sp.q // sp.kv) for j in range(sp.q)]:
        return None
    return idx


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
    sp = head_split(cfg, tp)
    group = None if tp is None else tp.group
    wq, wk, wv, wo = params.wq, params.wk, params.wv, params.wo
    if sp.q_whole:  # this rank's rows of the whole weights
        rows = slice(sp.q0 * hd, (sp.q0 + sp.q) * hd)
        wq, wo = wq[rows], wo[:, rows]
    x = copy_to_region(x, group)
    q = apply_linear(x, wq).reshape(b, s, sp.q, hd)
    k = apply_linear(x, wk).reshape(b, s, -1, hd)
    v = apply_linear(x, wv).reshape(b, s, -1, hd)
    if sp.kv_whole:
        k, v = k[:, :, sp.kv0 : sp.kv0 + sp.kv], v[:, :, sp.kv0 : sp.kv0 + sp.kv]
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    idx = _kv_index(sp, cfg.num_heads // cfg.num_kv_heads) if sp.q else None
    if cache is not None:
        new_cache = _cache_insert(cache, k, v, positions)
        k, v = new_cache["k"], new_cache["v"]
    if idx is not None:  # each query head's KV head, in the layout's order
        k, v = k[:, :, idx], v[:, :, idx]
    if sp.q == 0:
        # a padding rank of an uneven split: its empty K and V still join
        # the graph, so the backward collectives of their weights' gathers
        # run here as on the other ranks
        out = q + (k.sum() + v.sum())
    elif cache is not None:
        out = _naive_attention(
            q,
            k,
            v,
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
    out = apply_linear(out.reshape(b, s, sp.q * hd), wo)
    return reduce_from_region(out, group), new_cache

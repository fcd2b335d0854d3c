"""Mixture-of-Experts block (Mixtral 8 experts top-2; Llama-4 128 top-1 plus
a shared expert).

Counterpart of ``repro.models.moe`` (``init_moe``, ``_capacity``,
``moe_block``) on one device.  Every token picks its top-k experts; a
cumulative count over the flattened (token, choice) pairs, token-major,
gives each pair a slot in its expert; pairs whose slot reaches the
capacity C = ceil(T k capacity_factor / E) (rounded up to a multiple of 256
above 256) are dropped: their combine weight is zero.

The reference scatters the kept rows into an (E C, d) buffer and runs
batched expert GEMMs over it, padded slots included; with ``dropless`` its
capacity is the token count, so at full width (llama4: 128 experts) that
buffer and its (E, C, f) products run to tens of GB for a few thousand
tokens.  Here each expert's kept rows are gathered, in slot order, and
multiplied by its weights alone (one ``torch.matmul`` a weight an expert
that received rows): padded slots add nothing to the output, so the values
are the reference's.  The expert GEMMs are plain products, outside any
kernel in the reference too.

On a mesh (``settings.fsdp_gather``) the reference's numbers change, not
only its placement, and the port follows them:

* dispatch is shard-local over the data-parallel axes ("pod", "data"):
  capacity and slots count within each shard's contiguous token block,
  which is each data-parallel rank dispatching its own batch rows (so the
  batch must divide over them, ``distribution.sharding.shard_batch``);
* the aux loss stays global: ``density`` and ``density_prob`` are means
  over every token, their sums reduced over the data-parallel axes before
  the product;
* experts lie over "model" (EP, llama4) or are tensor-parallel inside
  each expert (mixtral), as ``shardspecs.moe_specs`` says; activations are
  replicated along "model", so the sum over "model" of the ranks' partial
  outputs combines the experts (no all-to-all).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.mesh import (
    axis_group,
    axis_size,
    copy_to_region,
    group_sum,
    reduce_from_region,
)
from . import settings
from .common import dense_init
from .mlp import MLP, mlp
from .shardspecs import batch_axes, expert_parallel, model_parallel


def _experts(e: int, fan_in: int, fan_out: int, dtype, *, generator, device):
    """(e, fan_in, fan_out) expert weights, ``dense_init`` at scale
    fan_in^-1/2 an expert at a time (the f32 draw of all experts at once
    would take twice the weights' bytes at full width)."""
    w = torch.empty((e, fan_in, fan_out), dtype=dtype, device=device)
    for i in range(e):
        w[i] = dense_init(
            (fan_in, fan_out), dtype, generator=generator, device=device
        )
    return nn.Parameter(w)


class MoE(nn.Module):
    """The weights of ``MoEParams``, in its layout: ``router`` (d, E) in
    float32 whatever the model's dtype, ``w_gate`` and ``w_up`` (E, d, f),
    ``w_down`` (E, f, d), and ``shared``, the always-on SwiGLU expert (None
    without one)."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        kw = dict(generator=generator, device=device)
        self.router = nn.Parameter(dense_init((d, e), torch.float32, **kw))
        self.w_gate = _experts(e, d, f, dtype, **kw)
        self.w_up = _experts(e, d, f, dtype, **kw)
        self.w_down = _experts(e, f, d, dtype, **kw)
        self.shared = None
        if cfg.moe_shared_expert:
            self.shared = MLP(d, f, "swiglu", dtype, **kw)


def _round_capacity(cap: int) -> int:
    """Up to a multiple of 256 once above 256, as the reference (its buffer
    shards evenly over the data axis there)."""
    return -(-cap // 256) * 256 if cap > 256 else cap


def _capacity(tokens: int, k: int, e: int, factor: float) -> int:
    """Slots an expert: ceil(tokens k factor / e), rounded."""
    cap = -(-int(tokens * k * factor) // e)
    return max(_round_capacity(cap), 1)


def moe_block(params: MoE, x, cfg, dropless: bool = False):
    """x: (B, S, d) -> ((B, S, d), the router's aux loss, a float32 scalar).

    ``dropless=True`` sizes each expert at the token count, so no pair is
    dropped (the cached serving paths: capacity dropping depends on how
    the sequence was batched, so a cached decode could not reproduce it).
    On a mesh, ``x`` holds this rank's batch rows (module note).
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    mesh = settings.FSDP_GATHER_MESH
    tp = model_parallel(mesh)
    group = tp.group

    logits = xf.float() @ params.router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # torch.topk and jax.lax.top_k may break ties in other orders; the
    # router's f32 softmax of continuous inputs gives no ties to break.
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balancing loss on the first choice (Switch / Mixtral), over
    # every token of the batch
    first = F.one_hot(expert_idx[:, 0], e).float()
    if mesh is None:
        density, density_prob = first.mean(dim=0), probs.mean(dim=0)
    else:
        dp = axis_group(mesh, batch_axes(mesh))
        total = t * axis_size(mesh, batch_axes(mesh))
        density = group_sum(first.sum(dim=0), dp) / total
        density_prob = reduce_from_region(probs.sum(dim=0), dp) / total
    aux_loss = e * torch.sum(density * density_prob)

    cap = _round_capacity(t) if dropless else _capacity(t, k, e, cfg.capacity_factor)
    # slot of each pair within its expert: pairs before it, token-major
    flat_e = expert_idx.reshape(-1)  # (T k,)
    onehot = F.one_hot(flat_e, e)
    slot = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = slot < cap
    gate_vals = gate_vals * keep.reshape(t, k).to(gate_vals.dtype)

    # this rank's experts: every one, or (EP) its slice of them
    e0, e1 = 0, e
    if expert_parallel(cfg):
        if e % tp.size:
            raise ValueError(
                f"{tp.size} model-parallel ranks do not divide {e} experts"
            )
        e0 = tp.rank * (e // tp.size)
        e1 = e0 + e // tp.size
    if settings.MOE_AT_CAPACITY:
        picked = _dispatch_at_capacity(params, xf, group, flat_e, slot, keep, k, e0, e1, cap)
    else:
        picked = _dispatch(params, xf, group, flat_e, keep, k, e0, e1)
    # combine in float32 (summed over the experts' ranks), then cast; each
    # rank's experts give a part of the gates' gradient
    gate = copy_to_region(gate_vals, group)
    y = (picked.reshape(t, k, d).float() * gate[..., None].float()).sum(dim=1)
    y = reduce_from_region(y, group).to(x.dtype)
    if params.shared is not None:
        y = y + mlp(params.shared, xf, "swiglu", tp)
    return y.reshape(b, s, d), aux_loss


def _expert(params, i, xe):
    """Expert i's SwiGLU of its rows ``xe`` (i may index a batch of them)."""
    h = F.silu(xe @ params.w_gate[i]) * (xe @ params.w_up[i])
    return h @ params.w_down[i]


def _dispatch(params, xf, group, flat_e, keep, k: int, e0: int, e1: int):
    """(T k, d): each kept pair's expert output (zero elsewhere), each of
    this rank's experts computing only its kept rows."""
    t, d = xf.shape
    # the kept pairs of these experts grouped by expert, each in slot order
    pairs = torch.nonzero(keep & (flat_e >= e0) & (flat_e < e1))[:, 0]
    order = torch.sort(flat_e[pairs], stable=True).indices
    pairs = pairs[order]
    counts = torch.bincount(flat_e[pairs] - e0, minlength=e1 - e0).tolist()
    rows = copy_to_region(xf, group)[pairs // k]
    out = torch.empty_like(rows)
    start = 0
    for i, n in enumerate(counts):
        if n:
            out[start : start + n] = _expert(params, i, rows[start : start + n])
        start += n
    picked = torch.zeros((t * k, d), dtype=xf.dtype, device=xf.device)
    picked[pairs] = out
    return picked


def _dispatch_at_capacity(params, xf, group, flat_e, slot, keep, k, e0, e1, cap):
    """``_dispatch`` at static shapes (``settings.moe_at_capacity``): every
    pair of this rank's experts is copied into an (E_local C, d) buffer at
    its slot, each expert computes all C rows of its buffer, and each kept
    pair reads its row back: the reference's capacity buffer, with no shape
    that depends on the routing."""
    d = xf.shape[1]
    el = e1 - e0
    mine = keep & (flat_e >= e0) & (flat_e < e1)
    dump = el * cap  # the row of every pair this rank does not compute
    dest = torch.where(mine, (flat_e - e0) * cap + slot, dump)
    rows = copy_to_region(xf, group).repeat_interleave(k, dim=0)
    buf = xf.new_zeros((dump + 1, d)).index_copy(0, dest, rows)
    out = _expert(params, slice(None), buf[:dump].reshape(el, cap, d))
    out = torch.cat([out.reshape(dump, d), out.new_zeros((1, d))])
    return out[dest]

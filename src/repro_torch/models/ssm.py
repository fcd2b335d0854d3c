"""Mamba-2 mixer: state-space duality (SSD), chunked scan form.

Counterpart of ``repro.models.ssm`` (Dao & Gu 2024, arXiv:2405.21060): with
a per-head scalar decay a_t = exp(dt_t A) and state size N,

  h_t = a_t h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t + D x_t,

computed in O(S) by chunks of length Q: an intra-chunk quadratic term (the
masked C B^T product) plus a recurrence over the chunks' states.  A decode
step keeps (conv state, SSM state) and costs O(1).  Plain PyTorch: the
reference has no Pallas kernel here.

As in the reference, a call with more than one token starts the recurrence
from a zero state whatever state it is given (only the conv state is
carried): right for a prefill from position 0, wrong after it.  The model
refuses such a call (``models.transformer``; ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import apply_linear, dense_init, linear, rms_norm


def _dims(cfg):
    """(d_in, heads, groups, state size, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    return d_in, heads, g, n, d_in + 2 * g * n


class SSM(nn.Module):
    """The weights of ``SSMParams``: ``w_in`` (d -> [z, x, B, C, dt]) and
    ``w_out`` (d_in -> d) as bias-free linears; ``conv_w`` (W, C) and
    ``conv_b`` (C,) of the depthwise causal conv; ``a_log``, ``dt_bias``
    and ``d_skip`` (H,) in float32; ``norm_w`` (d_in,), the gated RMSNorm's
    scale."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        d = cfg.d_model
        d_in, heads, g, n, conv_ch = _dims(cfg)
        kw = dict(generator=generator, device=device)
        self.w_in = linear(d, 2 * d_in + 2 * g * n + heads, dtype, **kw)
        self.conv_w = nn.Parameter(
            dense_init((cfg.ssm_conv_width, conv_ch), dtype, scale=0.5, **kw)
        )
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype, device=device))
        # dt log-uniform in [1e-3, 1e-1]; dt_bias its inverse softplus
        u = torch.rand(heads, generator=generator, device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.a_log = nn.Parameter(
            torch.log(torch.arange(1, heads + 1, dtype=torch.float32, device=device))
        )
        self.d_skip = nn.Parameter(torch.ones(heads, device=device))
        self.norm_w = nn.Parameter(torch.zeros(d_in, dtype=dtype, device=device))
        self.w_out = linear(d_in, d, dtype, **kw)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv then SiLU.  x: (B, S, C), w: (W, C), ``state``
    the previous W - 1 inputs (zeros if None).  Returns (y, new state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(
            (x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device
        )
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # (B, S + W - 1, C)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(width))
    return F.silu(y + b), xp[:, -(width - 1) :]


def _segsum(a_log):
    """log of the decay products: L[i, j] = sum_{j < m <= i} a_log[m], -inf
    above the diagonal."""
    q = a_log.shape[-1]
    cs = torch.cumsum(a_log, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a_log.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, a_log_h, bmat, cmat, chunk: int):
    """The SSD core.

    xh (B, S, H, P) the heads' inputs; dt (B, S, H) positive step sizes
    (after the softplus); a_log_h (H,) with A = -exp(a_log_h); bmat and
    cmat (B, S, G, N), H a multiple of G; S a multiple of ``chunk``.
    Returns y (B, S, H, P) and the final state (B, H, N, P) in float32.
    """
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, h // g

    a = -torch.exp(a_log_h) * dt  # (B, S, H) log-decay
    xd = xh * dt[..., None]  # dt-weighted input
    ac = a.reshape(b, nc, chunk, h)
    xc = xd.reshape(b, nc, chunk, h, p)
    bc = bmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = cmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    # 1. within each chunk: the masked (C B^T) product with the decays
    ldec = torch.exp(_segsum(ac.movedim(3, 2)))  # (B, nc, H, Q, Q)
    cb = torch.einsum("bzqhn,bzkhn->bzhqk", cc, bc)
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", cb * ldec, xc)

    # 2. each chunk's final state
    a_cum = torch.cumsum(ac, dim=2)  # (B, nc, Q, H)
    decay_to_end = torch.exp(a_cum[:, :, -1:] - a_cum)
    states = torch.einsum("bzqhn,bzqhp->bzhnp", bc * decay_to_end[..., None], xc)

    # 3. the recurrence over chunks, in float32: the state entering each
    chunk_decay = torch.exp(a_cum[:, :, -1]).float()  # (B, nc, H)
    carry = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z].float()
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    # 4. the entering state's part at each position
    state_decay = torch.exp(a_cum)  # (B, nc, Q, H)
    y_off = torch.einsum(
        "bzqhn,bzhnp->bzqhp", cc * state_decay[..., None], prev_states.to(cc.dtype)
    )
    return (y_diag + y_off).reshape(b, s, h, p), carry


def ssm_block(params: SSM, x, cfg, state=None):
    """The Mamba-2 mixer.  x: (B, S, d).

    ``state`` (decode): dict(conv=(B, W - 1, C) in the model dtype,
    ssm=(B, H, N, P) in float32).  Returns (y, new state).
    """
    b, s, _ = x.shape
    d_in, heads, g, n, conv_ch = _dims(cfg)
    p = cfg.ssm_head_dim

    proj = apply_linear(x, params.w_in)
    z, xbc, dt_raw = torch.split(proj, [d_in, conv_ch, heads], dim=-1)
    dt = F.softplus(dt_raw.float() + params.dt_bias)  # (B, S, H)

    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params.conv_w, params.conv_b, conv_state)
    xh, bmat, cmat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    xh = xh.reshape(b, s, heads, p)
    bmat = bmat.reshape(b, s, g, n)
    cmat = cmat.reshape(b, s, g, n)

    if state is None or s > 1:
        # prefill from a zero state; a ragged length is padded with dt = 0
        # steps (after the softplus), identities of the recurrence
        q = cfg.ssm_chunk
        pad = (-s) % q

        def padded(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

        y, final = ssd_chunked(
            padded(xh).float(),
            padded(dt),
            params.a_log,
            padded(bmat).float(),
            padded(cmat).float(),
            q,
        )
        y = y[:, :s]
    else:
        # the O(1) recurrent step (s == 1)
        a = torch.exp(-torch.exp(params.a_log) * dt[:, 0])  # (B, H)
        rep = heads // g
        bh = bmat[:, 0].repeat_interleave(rep, dim=1).float()  # (B, H, N)
        ch = cmat[:, 0].repeat_interleave(rep, dim=1).float()
        xdt = xh[:, 0].float() * dt[:, 0, :, None]  # (B, H, P)
        final = state["ssm"] * a[..., None, None] + bh[..., None] * xdt[:, :, None]
        y = torch.einsum("bhn,bhnp->bhp", ch, final)[:, None]  # (B, 1, H, P)

    y = y + params.d_skip[:, None] * xh.float()
    y = y.reshape(b, s, d_in).to(x.dtype)
    # gated RMSNorm, then the output projection
    y = rms_norm(y * F.silu(z), params.norm_w, cfg.norm_eps)
    return apply_linear(y, params.w_out), dict(conv=new_conv, ssm=final)


def init_ssm_state(cfg, batch: int, dtype, *, device):
    d_in, heads, _, n, conv_ch = _dims(cfg)
    return dict(
        conv=torch.zeros(
            (batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device
        ),
        ssm=torch.zeros(
            (batch, heads, n, cfg.ssm_head_dim), dtype=torch.float32, device=device
        ),
    )

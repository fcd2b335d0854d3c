"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  The Real-Gated Linear Recurrent
Unit:

  r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
  i_t = sigmoid(W_i x_t + b_i)              (input gate)
  log a_t = -c softplus(Lambda) r_t         (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

inside the recurrent block: linear in, temporal conv (width 4), RG-LRU,
gated linear out.  A prefill runs the recurrence as a log-depth scan over
time, a decode step as the O(1) update.  Plain PyTorch: the reference has
no Pallas kernel here.

As in the reference, a call with more than one token starts the recurrence
from h = 0 whatever state it is given (only the conv state is carried):
right for a prefill from position 0, wrong after it.  The model refuses
such a call (``models.transformer``; ROADMAP Queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import apply_linear, dense_init, linear

_C = 8.0


class RGLRU(nn.Module):
    """The weights of ``RGLRUParams``: ``w_x`` and ``w_gate`` (d -> L) and
    ``w_out`` (L -> d) as bias-free linears; ``conv_w`` (4, L) and
    ``conv_b`` (L,); the gate projections ``w_a`` and ``w_i`` (L, L) in the
    reference's (in, out) layout, applied in float32; ``b_a``, ``b_i`` and
    ``lam`` (Lambda) (L,) in float32."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        d = cfg.d_model
        lw = cfg.lru_width or d
        kw = dict(generator=generator, device=device)
        self.w_x = linear(d, lw, dtype, **kw)
        self.w_gate = linear(d, lw, dtype, **kw)
        self.conv_w = nn.Parameter(dense_init((4, lw), dtype, scale=0.5, **kw))
        self.conv_b = nn.Parameter(torch.zeros(lw, dtype=dtype, device=device))
        self.w_a = nn.Parameter(dense_init((lw, lw), dtype, **kw))
        self.b_a = nn.Parameter(torch.ones(lw, device=device))
        self.w_i = nn.Parameter(dense_init((lw, lw), dtype, **kw))
        self.b_i = nn.Parameter(torch.zeros(lw, device=device))
        # a ~ Uniform(0.9, 0.999) at r = 1 (the paper's appendix A):
        # Lambda = softplus^-1(-log u / c)
        u = 0.9 + 0.099 * torch.rand(lw, generator=generator, device=device)
        self.lam = nn.Parameter(torch.log(torch.expm1(-torch.log(u) / _C)))
        self.w_out = linear(lw, d, dtype, **kw)


def _conv1d(x, w, b, state=None):
    """Causal temporal conv over (B, S, L) with the previous W - 1 inputs
    ``state`` (zeros if None).  Returns (y, new state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(
            (x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device
        )
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(width))
    return y + b, xp[:, -(width - 1) :]


def rglru_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 from h = 0, as a
    Hillis-Steele scan: log2(S) passes, each combining every prefix with
    the one ``offset`` steps before it as the reference's associative scan
    combines two (decays multiply, so every factor is at most 1)."""
    s = log_a.shape[1]
    offset = 1
    while offset < s:
        later = torch.exp(log_a[:, offset:]) * b[:, :-offset] + b[:, offset:]
        b = torch.cat([b[:, :offset], later], dim=1)
        log_a = torch.cat(
            [log_a[:, :offset], log_a[:, offset:] + log_a[:, :-offset]], dim=1
        )
        offset *= 2
    return b


def rglru_block(params: RGLRU, x, cfg, state=None):
    """x: (B, S, d) -> (B, S, d).  ``state`` (decode): dict(conv=(B, 3, L)
    in the model dtype, h=(B, L) in float32).  Returns (out, new state)."""
    s = x.shape[1]
    xb = apply_linear(x, params.w_x)
    # jax.nn.gelu's default
    gate = F.gelu(apply_linear(x, params.w_gate), approximate="tanh")
    conv_state = None if state is None else state["conv"]
    xb, new_conv = _conv1d(xb, params.conv_w, params.conv_b, conv_state)

    xf = xb.float()
    r = torch.sigmoid(xf @ params.w_a.float() + params.b_a)
    i = torch.sigmoid(xf @ params.w_i.float() + params.b_i)
    log_a = -_C * F.softplus(params.lam) * r  # (B, S, L)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated_in = beta * (i * xf)

    if state is None or s > 1:
        h = rglru_scan(log_a, gated_in)  # from h = 0
        new_h = h[:, -1]
    else:
        new_h = torch.exp(log_a[:, 0]) * state["h"] + gated_in[:, 0]
        h = new_h[:, None]
    out = apply_linear(h.to(x.dtype) * gate, params.w_out)
    return out, dict(conv=new_conv, h=new_h)


def init_rglru_state(cfg, batch: int, dtype, *, device):
    lw = cfg.lru_width or cfg.d_model
    return dict(
        conv=torch.zeros((batch, 3, lw), dtype=dtype, device=device),
        h=torch.zeros((batch, lw), dtype=torch.float32, device=device),
    )

"""Plain PyTorch versions of the hand-written kernels.

Counterparts of ``repro.kernels.ref``.  A CPU tensor takes these in
``kernels.ops``; on the card they are what each kernel is checked against.
"""

from __future__ import annotations

import torch

from ..core.matern import matern_correlation, matern_correlation_halfint
from ..core.recovery import cholesky_or_nan


def matern_tile_ref(locs_a, locs_b, inv_range, amp, nu) -> torch.Tensor:
    """Covariance tile C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range) for
    any order nu > 0."""
    d2 = torch.sum((locs_a[:, None, :] - locs_b[None, :, :]) ** 2, dim=-1)
    u = torch.sqrt(torch.clamp(d2, min=0.0)) * inv_range
    return matern_corr_ref(u, amp, nu)


def matern_corr_ref(u, amp, nu) -> torch.Tensor:
    """amp * M_nu(u) elementwise: the closed form for nu in {0.5, 1.5, 2.5},
    ``core.matern.matern_correlation`` (the vectorised K_nu) otherwise."""
    v = float(nu)
    if v in (0.5, 1.5, 2.5):
        return amp * matern_correlation_halfint(u, v)
    return amp * matern_correlation(u, nu)


def tlr_mm_ref(u_a, v_a, u_b, v_b, acc) -> torch.Tensor:
    """acc - U_a (V_a^T V_b) U_b^T, batched over the leading dim."""
    w = v_a.mT @ v_b
    return acc - (u_a @ w) @ u_b.mT


def potrf_ref(a) -> torch.Tensor:
    """Batched lower Cholesky factor of SPD tiles (B, nb, nb).

    A tile whose factorization meets a pivot that is not positive and finite
    comes back all NaN, as from ``jnp.linalg.cholesky``
    (``core.recovery.cholesky_or_nan``).
    """
    return cholesky_or_nan(a)


def trsm_ref(lo, b) -> torch.Tensor:
    """X = L^{-1} B (batched, lower): lo (B or 1, nb, nb), b (B, nb, r)."""
    return torch.linalg.solve_triangular(lo, b, upper=False, left=True)


def syrk_ref(c, a) -> torch.Tensor:
    """C - A A^T (batched trailing symmetric update): c (B, nb, nb), a (B, nb, k)."""
    return c - a @ a.mT


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Multi-head attention: q (BH, Sq, D); k, v (BKV, Skv, D) with
    BH = BKV * group.  Queries are right-aligned to the keys; f32 scores,
    softmax and P V whatever the input dtype; returns (BH, Sq, D) in q's
    dtype."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    if scale is None:
        scale = 1.0 / d**0.5
    kq = k.repeat_interleave(group, dim=0).float()
    vq = v.repeat_interleave(group, dim=0).float()
    scores = (q.float() @ kq.mT) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return (probs @ vq).to(q.dtype)

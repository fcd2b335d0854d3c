"""Plain PyTorch versions of the hand-written kernels.

Counterparts of ``repro.kernels.ref``.  A CPU tensor takes these in
``kernels.ops``; on the card they are what each kernel is checked against.
"""

from __future__ import annotations

import torch

from ..core.matern import matern_correlation_halfint
from ..core.recovery import cholesky_or_nan


def matern_tile_ref(locs_a, locs_b, inv_range, amp, nu: float) -> torch.Tensor:
    """Covariance tile C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range).

    nu is a half-integer in {0.5, 1.5, 2.5}.
    """
    d2 = torch.sum((locs_a[:, None, :] - locs_b[None, :, :]) ** 2, dim=-1)
    u = torch.sqrt(torch.clamp(d2, min=0.0)) * inv_range
    return amp * matern_correlation_halfint(u, nu)


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

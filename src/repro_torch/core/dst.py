"""Diagonal Super Tile (DST) baseline (§4.4, Experiment 2).

Counterpart of ``repro.core.dst``.  Covariance-tapering-style
approximation: tiles whose distance from the diagonal exceeds the kept band
are annihilated (set to zero).  "DST 40/60" keeps the 40% of tile-diagonals
nearest the main diagonal and zeroes the remaining 60%.  The paper uses DST
as the baseline the TLR approach beats in estimation accuracy (Fig. 13).
"""

from __future__ import annotations

import math

import torch

from ..device import as_tensor
from .covariance import MaternParams, build_sigma
from .likelihood import LoglikResult, _solve_lower
from .recovery import cholesky_or_nan
from .tlr import choose_tile_size


def dst_mask(m: int, tile_size: int, keep_fraction: float, *, device=None):
    """(m, m) bool mask keeping tiles with |i - j| <= keep_fraction * (T-1)."""
    nb = tile_size
    T = m // nb
    band = keep_fraction * max(T - 1, 1)
    ti = torch.arange(m, device=device) // nb
    dist = torch.abs(ti[:, None] - ti[None, :])
    return dist <= band


def dst_apply(sigma: torch.Tensor, tile_size: int = 0, keep_fraction: float = 0.7):
    m = sigma.shape[0]
    nb = choose_tile_size(m, tile_size)
    mask = dst_mask(m, nb, keep_fraction, device=sigma.device)
    return torch.where(mask, sigma, torch.zeros_like(sigma))


def dst_loglik(
    dists,
    z,
    params: MaternParams,
    keep_fraction: float = 0.7,
    tile_size: int = 0,
    nugget: float = 0.0,
    representation: str = "I",
    *,
    device=None,
) -> LoglikResult:
    """Eq. (1) with the DST-annihilated covariance.

    Annihilation can break positive definiteness (the paper's motivation for
    preferring TLR); a failed Cholesky yields a NaN factor and a NaN loglik,
    which the MLE driver maps to a large penalty, as in the reference.
    """
    sigma = build_sigma(
        None,
        params,
        representation=representation,
        nugget=nugget,
        dists=dists,
        device=device,
    )
    sigma = dst_apply(sigma, tile_size=tile_size, keep_fraction=keep_fraction)
    chol = cholesky_or_nan(sigma)
    del sigma
    z = as_tensor(z, device=chol.device, dtype=chol.dtype)
    m = z.shape[-1]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    alpha = _solve_lower(chol, z)
    quad = torch.sum(alpha * alpha)
    ll = -0.5 * (m * math.log(2.0 * math.pi) + logdet + quad)
    return LoglikResult(ll, logdet, quad, None)


def dst_memory_bytes(m: int, tile_size: int, keep_fraction: float, itemsize: int = 8):
    nb = tile_size
    T = m // nb
    band = keep_fraction * max(T - 1, 1)
    kept = sum(1 for i in range(T) for j in range(T) if abs(i - j) <= band)
    return kept * nb * nb * itemsize

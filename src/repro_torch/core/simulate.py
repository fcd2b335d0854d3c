"""Synthetic multivariate Gaussian random fields (paper §6.4.1).

Counterpart of ``repro.core.simulate``: exact samples Z = L eps with L the
Cholesky factor of Sigma(theta), on regular or uniform random locations.
The location helpers are host-side numpy, copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from .covariance import MaternParams, build_sigma


def grid_locations(
    nx: int, ny: int | None = None, jitter: float = 0.0, seed: int = 0
) -> np.ndarray:
    """Regular (optionally jittered) grid on the unit square, (nx*ny, 2)."""
    ny = nx if ny is None else ny
    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    locs = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    if jitter != 0.0:
        rng = np.random.default_rng(seed)
        locs = locs + rng.uniform(-jitter / nx, jitter / nx, size=locs.shape)
    return locs


def uniform_locations(n: int, seed: int = 0) -> np.ndarray:
    """n iid-uniform locations on the unit square (irregular sampling)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(n, 2))


def simulate_mgrf(
    generator: torch.Generator | None,
    locs,
    params: MaternParams,
    representation: str = "I",
    nugget: float = 0.0,
    nsamples: int = 1,
    *,
    eps=None,
    device=None,
) -> torch.Tensor:
    """Exact sample(s) from the zero-mean multivariate GRF.

    Returns (nsamples, p*n) ordered per ``representation``.  The standard
    normal draws ``eps`` (nsamples, p*n) come from ``generator`` (which must
    live on the device the samples are made on) unless they are passed in;
    passing them lets two implementations share one draw.
    """
    sigma = build_sigma(
        locs, params, representation=representation, nugget=nugget, device=device
    )
    chol = torch.linalg.cholesky(sigma)
    del sigma
    shape = (nsamples, chol.shape[0])
    if eps is None:
        eps = torch.randn(
            shape, generator=generator, dtype=chol.dtype, device=chol.device
        )
    else:
        eps = as_tensor(eps, device=chol.device, dtype=chol.dtype).reshape(shape)
    return eps @ chol.mT

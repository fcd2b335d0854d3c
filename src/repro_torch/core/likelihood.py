"""Gaussian log-likelihood (Eq. 1): exact dense path + profile likelihood.

Counterpart of ``repro.core.likelihood``.

l(theta) = -np/2 log(2 pi) - 1/2 log|Sigma| - 1/2 Z^T Sigma^{-1} Z

The profile path (§5.2) removes the p marginal variances from the
optimization and recovers them in closed form:
sigma_ii^2 = n^{-1} Z_i^T R_ii(theta_i)^{-1} Z_i.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import as_tensor
from .covariance import (
    MaternParams,
    build_correlation_matrix,
    build_sigma,
    pairwise_distances,
)
from .recovery import FactorStatus, cholesky_or_nan, init_status


class LoglikResult(NamedTuple):
    loglik: torch.Tensor
    logdet: torch.Tensor
    quad: torch.Tensor  # Z^T Sigma^{-1} Z
    chol: torch.Tensor | None  # lower Cholesky factor (None if not kept)
    status: FactorStatus | None = None  # factorization health


def _solve_lower(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """L^{-1} z for z of shape (m,) or (s, m)."""
    rhs = z[:, None] if z.dim() == 1 else z.mT
    out = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return out[:, 0] if z.dim() == 1 else out.mT


def loglik_from_chol(
    chol: torch.Tensor, z, keep_chol: bool = False, status: FactorStatus | None = None
) -> LoglikResult:
    """Log-likelihood given the lower Cholesky factor of Sigma.

    Without a ``status``, one is derived from the factor's diagonal.
    """
    z = as_tensor(z, device=chol.device, dtype=chol.dtype)
    m = z.shape[-1]
    if status is None:
        status = init_status(chol.dtype, chol.device).update_potrf(chol)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    alpha = _solve_lower(chol, z)
    quad = torch.sum(alpha * alpha, dim=-1)
    ll = -0.5 * (m * math.log(2.0 * math.pi) + logdet + quad)
    return LoglikResult(ll, logdet, quad, chol if keep_chol else None, status)


def exact_loglik(
    locs,
    z,
    params: MaternParams,
    representation: str = "I",
    nugget: float = 0.0,
    dists=None,
    keep_chol: bool = False,
    *,
    device=None,
) -> LoglikResult:
    """Dense-Cholesky evaluation of Eq. (1).

    A Sigma that is not positive definite gives a NaN factor (and a status
    that is not ok), as in the reference.
    """
    sigma = build_sigma(
        locs,
        params,
        representation=representation,
        nugget=nugget,
        dists=dists,
        device=device,
    )
    chol = cholesky_or_nan(sigma)
    del sigma
    return loglik_from_chol(chol, z, keep_chol=keep_chol)


def profile_variances(
    dists,
    z,
    a,
    nu,
    p: int,
    nugget: float = 0.0,
    representation: str = "I",
    *,
    device=None,
):
    """Closed-form marginal variance estimates (profile trick, §5.2).

    z is the (p*n,) data vector in the given representation ordering.
    Returns (p,) sigma_ii^2 estimates.
    """
    dists = as_tensor(dists, device=device)
    z = as_tensor(z, device=dists.device, dtype=dists.dtype)
    n = dists.shape[0]
    out = []
    for i in range(p):
        r = build_correlation_matrix(None, a, nu[i], nugget=nugget, dists=dists)
        chol = cholesky_or_nan(r)
        zi = z[i::p] if representation.upper() == "I" else z[i * n : (i + 1) * n]
        alpha = _solve_lower(chol, zi)
        out.append(torch.sum(alpha * alpha) / n)
    return torch.stack(out)


def profile_loglik(
    locs,
    z,
    a,
    nu,
    beta,
    p: int,
    representation: str = "I",
    nugget: float = 0.0,
    dists=None,
    *,
    device=None,
) -> LoglikResult:
    """Profile log-likelihood: variances replaced by their marginal estimates
    (§5.2); only (a, nu_i, beta_ij) are left to the optimizer."""
    if dists is None:
        dists = pairwise_distances(as_tensor(locs, device=device))
    else:
        dists = as_tensor(dists, device=device)
    sigma2_hat = profile_variances(
        dists, z, a, nu, p, nugget=nugget, representation=representation
    )
    kw = dict(dtype=dists.dtype, device=dists.device)
    params = MaternParams(
        sigma2=sigma2_hat,
        a=torch.as_tensor(a, **kw),
        nu=torch.as_tensor(nu, **kw),
        beta=torch.as_tensor(beta, **kw),
    )
    return exact_loglik(
        None, z, params, representation=representation, nugget=nugget, dists=dists
    )

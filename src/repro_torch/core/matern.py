"""Matérn and parsimonious multivariate Matérn cross-covariance functions.

Counterpart of ``repro.core.matern``:

* ``kv`` — modified Bessel function of the second kind K_nu(x) for real
  order nu > 0 (Temme series for x <= 2, Steed's CF2 continued fraction for
  x > 2, upward recurrence in the order).  ``torch.special`` has no
  real-order K_nu, so the reference algorithm is carried over in full.
* ``matern_correlation`` — M_nu(u) = u^nu K_nu(u) / (2^{nu-1} Gamma(nu)),
  M_nu(0) = 1, with closed forms for nu in {1/2, 3/2, 5/2};
  ``matern_covariance`` and ``effective_range`` (the paper's ER) on it.
* ``parsimonious_rho`` / ``cross_covariance`` — Eq. (2) of the paper.

The order nu is a concrete scalar (a float or a 0-d tensor): the number of
upward recurrences is read from it on the host.  The two convergence loops
run on the host until every element has converged or ``max_iter`` is
reached, as the reference's ``while_loop``s do.  All functions keep the
input dtype.
"""

from __future__ import annotations

import math

import torch

from ..device import as_tensor

# Euler–Mascheroni constant (the mu -> 0 limit of the Temme series).
_EULER_GAMMA = 0.5772156649015328606


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _chepolish(mu: torch.Tensor):
    """gam1, gam2, gampl, gammi used by the Temme series.

    gampl = 1/Gamma(1+mu),   gammi = 1/Gamma(1-mu)
    gam1  = (gammi - gampl) / (2 mu)      (-> -EulerGamma as mu -> 0)
    gam2  = (gammi + gampl) / 2
    """
    gampl = torch.exp(-torch.lgamma(1.0 + mu))
    gammi = torch.exp(-torch.lgamma(1.0 - mu))
    small = torch.abs(mu) < 1e-6
    one = torch.ones_like(mu)
    gam1 = torch.where(
        small,
        -_EULER_GAMMA + mu * mu * 0.0,
        (gammi - gampl) / torch.where(small, one, 2.0 * mu),
    )
    gam2 = 0.5 * (gammi + gampl)
    return gam1, gam2, gampl, gammi


def _kv_temme_series(mu: torch.Tensor, x: torch.Tensor, max_iter: int = 200):
    """K_mu(x) and K_{mu+1}(x) for x <= 2, |mu| <= 1/2 (Temme's method)."""
    eps = torch.finfo(x.dtype).eps
    x = torch.clamp(x, min=1e-30)

    x2 = 0.5 * x
    pimu = math.pi * mu
    one = torch.ones_like(mu)
    fact = torch.where(torch.abs(pimu) < 1e-12, one, pimu / torch.sin(pimu))
    d = -torch.log(x2)
    e = mu * d
    tiny = torch.abs(e) < 1e-12
    fact2 = torch.where(
        tiny, torch.ones_like(e), torch.sinh(e) / torch.where(tiny, 1.0, e)
    )
    gam1, gam2, gampl, gammi = _chepolish(mu)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    ksum, ksum1 = ff, p
    done = torch.zeros_like(x, dtype=torch.bool)
    i = 1
    while i <= max_iter and not bool(done.all()):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        delk = c * ff
        delk1 = c * (p - fi * ff)
        ksum = torch.where(done, ksum, ksum + delk)
        ksum1 = torch.where(done, ksum1, ksum1 + delk1)
        done = done | (torch.abs(delk) < torch.abs(ksum) * eps)
        i += 1
    return ksum, ksum1 * 2.0 / x


def _kv_steed_cf2(mu: torch.Tensor, x: torch.Tensor, max_iter: int = 400):
    """K_mu(x) and K_{mu+1}(x) for x > 2, |mu| <= 1/2 (Steed's CF2)."""
    eps = torch.finfo(x.dtype).eps
    ones = torch.ones_like(x)
    a1 = 0.25 - mu * mu
    a = -a1 * ones
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = ones
    q = a1 * ones
    c = a1 * ones
    s = 1.0 + q * delh
    done = torch.zeros_like(x, dtype=torch.bool)
    i = 2
    while i <= max_iter + 1 and not bool(done.all()):
        fi = float(i)
        a = a - 2.0 * (fi - 1.0)
        c = -a * c / fi
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        hn = h + delh
        dels = q * delh
        sn = s + dels
        h = torch.where(done, h, hn)
        s = torch.where(done, s, sn)
        done = done | (torch.abs(dels / sn) < eps)
        i += 1
    h = a1 * h
    rkmu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    rk1 = rkmu * (mu + x + 0.5 - h) / x
    return rkmu, rk1


def kv(nu, x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel function of the second kind K_nu(x).

    nu: concrete scalar > 0.  x: floating tensor > 0.  Mirrors Numerical
    Recipes' ``bessik``: reduce nu = nl + mu with |mu| <= 1/2, evaluate
    K_mu, K_{mu+1} (Temme for x <= 2, CF2 for x > 2), then recur upward.
    """
    if not x.is_floating_point():
        x = x.to(torch.float64)
    nu_f = float(nu)
    nl = math.floor(nu_f + 0.5)  # number of upward recurrences
    mu = _scalar(nu, x) - float(nl)

    xs = torch.clamp(x, min=1e-30)
    k_small = _kv_temme_series(mu, torch.clamp(xs, max=2.0))
    k_large = _kv_steed_cf2(mu, torch.clamp(xs, min=2.0))
    use_small = xs <= 2.0
    rkmu = torch.where(use_small, k_small[0], k_large[0])
    rk1 = torch.where(use_small, k_small[1], k_large[1])
    for i in range(1, nl + 1):
        rktemp = (mu + float(i)) * (2.0 / xs) * rk1 + rkmu
        rkmu, rk1 = rk1, rktemp
    return rkmu


def kv_half_integer(nu_half: float, x: torch.Tensor) -> torch.Tensor:
    """Closed-form K_{n+1/2}(x) for nu_half in {0.5, 1.5, 2.5}."""
    pref = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x)
    if nu_half == 0.5:
        return pref
    if nu_half == 1.5:
        return pref * (1.0 + 1.0 / x)
    if nu_half == 2.5:
        return pref * (1.0 + 3.0 / x + 3.0 / (x * x))
    raise ValueError(f"no closed form wired for nu={nu_half}")


# ---------------------------------------------------------------------------
# Matérn correlation
# ---------------------------------------------------------------------------


def matern_correlation_halfint(u: torch.Tensor, nu_half: float) -> torch.Tensor:
    """M_nu(u) for a half-integer nu in {0.5, 1.5, 2.5} (exp/mul only)."""
    zero = u <= 0.0
    us = torch.where(zero, 1.0, u)
    if nu_half == 0.5:
        val = torch.exp(-us)
    elif nu_half == 1.5:
        val = (1.0 + us) * torch.exp(-us)
    elif nu_half == 2.5:
        val = (1.0 + us + us * us / 3.0) * torch.exp(-us)
    else:
        raise ValueError(f"no closed form wired for nu={nu_half}")
    return torch.where(zero, torch.ones_like(val), val)


def matern_correlation(u: torch.Tensor, nu) -> torch.Tensor:
    """M_nu(u) = u^nu K_nu(u) / (2^{nu-1} Gamma(nu)); M_nu(0) = 1."""
    if not u.is_floating_point():
        u = u.to(torch.float64)
    nu_t = _scalar(nu, u)
    zero = u <= 0.0
    us = torch.where(zero, 1.0, u)
    lognorm = (nu_t - 1.0) * math.log(2.0) + torch.lgamma(nu_t)
    val = torch.exp(nu_t * torch.log(us) - lognorm) * kv(nu, us)
    return torch.where(zero, torch.ones_like(val), val)


def matern_covariance(h, sigma2, a, nu, *, device=None) -> torch.Tensor:
    """Marginal Matérn covariance sigma2 * M_nu(h / a); numpy ``h`` goes to
    ``device``."""
    return sigma2 * matern_correlation(as_tensor(h, device=device) / a, nu)


def effective_range(a, nu, target=0.05, rmax=10.0, iters=60, *, device=None):
    """Distance at which the correlation drops to ``target`` (paper's ER).

    Bisection on M_nu(r/a) = target, elementwise over ``a``; ER = {0.1, 0.3,
    0.7} <-> a = {0.03, 0.09, 0.2} at nu = 0.5.  A non-tensor ``a`` goes to
    ``device``.
    """
    a = as_tensor(a, device=device)
    if not a.is_floating_point():
        a = a.to(torch.float64)
    lo, hi = torch.zeros_like(a), torch.full_like(a, rmax)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = matern_correlation(mid / a, nu) > target
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Parsimonious multivariate Matérn (Eq. (2))
# ---------------------------------------------------------------------------


def parsimonious_nu_matrix(nus: torch.Tensor) -> torch.Tensor:
    """nu_ij = (nu_ii + nu_jj) / 2 for the parsimonious model."""
    return 0.5 * (nus[:, None] + nus[None, :])


def parsimonious_rho(nus: torch.Tensor, beta: torch.Tensor, d: int = 2):
    """Colocated cross-correlation matrix rho_ij from the latent beta_ij.

    rho_ij = beta_ij * sqrt(G(nu_i + d/2)/G(nu_i)) * sqrt(G(nu_j + d/2)/G(nu_j))
             * G((nu_i + nu_j)/2) / G((nu_i + nu_j)/2 + d/2);   rho_ii = 1.
    """
    dtype = torch.promote_types(nus.dtype, beta.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float64
    nus = nus.to(dtype)
    beta = beta.to(dtype)
    gln = torch.lgamma
    half_d = 0.5 * d
    gmarg = 0.5 * (gln(nus + half_d) - gln(nus))
    nu_ij = parsimonious_nu_matrix(nus)
    logfac = gmarg[:, None] + gmarg[None, :] + gln(nu_ij) - gln(nu_ij + half_d)
    rho = beta * torch.exp(logfac)
    p = nus.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=nus.device)
    return torch.where(eye, torch.ones_like(rho), rho)


def cross_covariance(h: torch.Tensor, sigma2s, a, nus, beta, d: int = 2):
    """The p x p matrix C(h; theta) of Eq. (2) at lags ``h``.

    Returns a tensor of shape h.shape + (p, p).
    """
    p = sigma2s.shape[0]
    rho = parsimonious_rho(nus, beta, d=d)
    sig = torch.sqrt(sigma2s)
    amp = rho * (sig[:, None] * sig[None, :])
    nu_ij = parsimonious_nu_matrix(nus)
    u = h / a
    corr = torch.stack(
        [
            torch.stack([matern_correlation(u, nu_ij[i, j]) for j in range(p)], -1)
            for i in range(p)
        ],
        -2,
    )
    return amp * corr

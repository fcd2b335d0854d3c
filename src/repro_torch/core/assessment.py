"""MLOE/MMOM prediction-efficiency criteria, univariate and multivariate.

Counterpart of ``repro.core.assessment``: Algorithm 1 of the paper (the
multivariate extension of Hong et al. 2019's criteria), with the cokriging
operators

  E_t   = tr{ C(0;th) - c0_t^T Sigma(th)^-1 c0_t }                     (Eq. 5)
  E_t,a = tr{ C(0;th) - 2 c0_t^T Sigma(tha)^-1 c0_a
                      + c0_a^T Sigma(tha)^-1 Sigma(th) Sigma(tha)^-1 c0_a } (Eq. 6)
  E_a   = Eq. (5) with (tha, c0_a)

  LOE^CK(s0) = E_t,a / E_t - 1,     MOM^CK(s0) = E_a / E_t,a - 1
  MLOE^CK    = mean_l LOE^CK(s0_l), MMOM^CK    = mean_l MOM^CK(s0_l)   (Eqs. 7-8)

The univariate criteria are the p = 1 case of the same code.

The three phases are the paper's (its Figs. 10-11 split): GEN builds the
two dense Sigmas (``build_sigma``: the ``matern_corr`` kernel on the card),
FACT their Cholesky factors (``recovery.cholesky_or_nan``, the library
factorization, as the reference's ``jnp.linalg.cholesky`` is), and COMP the
criteria for every prediction location at once: the c0 columns of all
locations are folded into one (pn, npred*p) panel, so the paper's
per-location Level-2 loop becomes two batched Cholesky solves and one
``sigma_t @ xa`` product (plain large products, outside any kernel in the
reference too) and per-location traces.  Given a ``times`` dict,
``mloe_mmom`` adds the seconds of ``gen``, ``fact`` and ``comp`` to it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .covariance import MaternParams, build_c0, build_sigma, cross_cov_at_zero
from .recovery import cholesky_or_nan
from .tlr import _lap


class MloeMmomResult(NamedTuple):
    mloe: torch.Tensor
    mmom: torch.Tensor
    loe: torch.Tensor  # (npred,) per-location LOE^CK
    mom: torch.Tensor  # (npred,) per-location MOM^CK
    e_t: torch.Tensor  # (npred,)
    e_ta: torch.Tensor  # (npred,)
    e_a: torch.Tensor  # (npred,)


# -- phase 1-2: GEN + FACT (lines 1-4 of Algorithm 1) ------------------------


def gen_matrices(
    obs_locs,
    theta_true: MaternParams,
    theta_approx: MaternParams,
    representation: str = "I",
    nugget: float = 0.0,
    *,
    device=None,
):
    """Sigma(theta) and Sigma(theta_a), dense (pn, pn)."""
    kw = dict(representation=representation, nugget=nugget, device=device)
    sigma_t = build_sigma(obs_locs, theta_true, **kw)
    sigma_a = build_sigma(obs_locs, theta_approx, **kw)
    return sigma_t, sigma_a


def fact_matrices(sigma_t, sigma_a):
    """Lower Cholesky factors of both; a matrix that is not positive
    definite gives a NaN factor, as ``jnp.linalg.cholesky`` does."""
    return cholesky_or_nan(sigma_t), cholesky_or_nan(sigma_a)


# -- phase 3: COMP (lines 5-15), batched over all prediction locations -------


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b, chol, upper=False)


def comp_criteria(
    obs_locs,
    pred_locs,
    theta_true: MaternParams,
    theta_approx: MaternParams,
    sigma_t,
    chol_t,
    chol_a,
    representation: str = "I",
) -> MloeMmomResult:
    """The criteria at every prediction location from Sigma(theta) and both
    factors: one fold of all locations' c0 columns, batched solves and
    products, per-location traces (no loop over locations)."""
    p = theta_true.p
    dev = chol_t.device
    c0t = build_c0(pred_locs, obs_locs, theta_true, representation, device=dev)
    c0a = build_c0(pred_locs, obs_locs, theta_approx, representation, device=dev)
    npred, pn, _ = c0t.shape

    # Batched solves: fold (npred, pn, p) -> (pn, npred*p).
    c0t_flat = c0t.movedim(0, 1).reshape(pn, npred * p)
    c0a_flat = c0a.movedim(0, 1).reshape(pn, npred * p)
    del c0t, c0a
    xt = _cho_solve(chol_t, c0t_flat)  # Sigma(th)^-1 c0_t
    xa = _cho_solve(chol_a, c0a_flat)  # Sigma(tha)^-1 c0_a
    sig_xa = sigma_t @ xa  # Sigma(th) xa

    def per_loc_traces(a_flat, b_flat):
        # tr(a_l^T b_l) for each location l: both (pn, npred*p).
        prod = torch.sum(a_flat * b_flat, dim=0)  # (npred*p,)
        return torch.sum(prod.reshape(npred, p), dim=1)  # (npred,)

    c00_t = torch.trace(cross_cov_at_zero(theta_true))
    c00_a = torch.trace(cross_cov_at_zero(theta_approx))

    e_t = c00_t - per_loc_traces(c0t_flat, xt)
    e_ta = c00_t - 2.0 * per_loc_traces(c0t_flat, xa) + per_loc_traces(xa, sig_xa)
    e_a = c00_a - per_loc_traces(c0a_flat, xa)

    loe = e_ta / e_t - 1.0
    mom = e_a / e_ta - 1.0
    return MloeMmomResult(
        torch.mean(loe), torch.mean(mom), loe, mom, e_t, e_ta, e_a
    )


def mloe_mmom(
    obs_locs,
    pred_locs,
    theta_true: MaternParams,
    theta_approx: MaternParams,
    representation: str = "I",
    nugget: float = 0.0,
    *,
    device=None,
    times: dict | None = None,
) -> MloeMmomResult:
    """Full Algorithm 1 (GEN -> FACT -> COMP), any p >= 1.  Numpy locations
    go to ``device`` (the CUDA device unless ``"cpu"`` is asked for)."""
    t0 = _lap(times, None, 0.0, theta_true.sigma2)
    sigma_t, sigma_a = gen_matrices(
        obs_locs,
        theta_true,
        theta_approx,
        representation=representation,
        nugget=nugget,
        device=device,
    )
    t0 = _lap(times, "gen", t0, sigma_t)
    chol_t, chol_a = fact_matrices(sigma_t, sigma_a)
    del sigma_a  # COMP reads Sigma(theta) and the two factors only
    t0 = _lap(times, "fact", t0, chol_t)
    res = comp_criteria(
        obs_locs,
        pred_locs,
        theta_true,
        theta_approx,
        sigma_t,
        chol_t,
        chol_a,
        representation=representation,
    )
    _lap(times, "comp", t0, res.mloe)
    return res


def mloe_mmom_univariate(
    obs_locs,
    pred_locs,
    sigma2_t,
    a_t,
    nu_t,
    sigma2_a,
    a_a,
    nu_a,
    nugget: float = 0.0,
    *,
    device=None,
) -> MloeMmomResult:
    """Univariate criteria (Hong et al. 2019) as the p = 1 case of
    Algorithm 1."""
    th_t = MaternParams.univariate(
        float(sigma2_t), float(a_t), float(nu_t), device=device
    )
    th_a = MaternParams.univariate(
        float(sigma2_a), float(a_a), float(nu_a), device=device
    )
    return mloe_mmom(obs_locs, pred_locs, th_t, th_a, nugget=nugget, device=device)


def naive_multivariate_mloe_mmom(
    obs_locs,
    pred_locs,
    theta_true: MaternParams,
    theta_approx: MaternParams,
    nugget: float = 0.0,
    *,
    device=None,
):
    """The 'naive extension' the paper contrasts against (§5.4): the mean of
    the per-variable univariate MLOE/MMOMs, ignoring cross-correlation."""
    p = theta_true.p
    if device is None:
        device = theta_true.sigma2.device
    loes, moms = [], []
    for i in range(p):
        r = mloe_mmom_univariate(
            obs_locs,
            pred_locs,
            theta_true.sigma2[i],
            theta_true.a,
            theta_true.nu[i],
            theta_approx.sigma2[i],
            theta_approx.a,
            theta_approx.nu[i],
            nugget=nugget,
            device=device,
        )
        loes.append(r.mloe)
        moms.append(r.mmom)
    return torch.mean(torch.stack(loes)), torch.mean(torch.stack(moms))

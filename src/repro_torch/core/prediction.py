"""Cokriging prediction (Eq. 3) and prediction-error metrics (§4.5).

Counterpart of ``repro.core.prediction``:

    Z_hat(s0) = c0^T Sigma(theta)^{-1} Z

``CokrigeFactor`` is the factor-once / predict-many handle: the Cholesky
factor of Sigma (dense (m, m), or the pair-major TLR tiles of
``core.dist_tlr``), the precomputed ``alpha = Sigma^{-1} z`` and the
observation geometry.  ``cokrige`` and ``cokrige_and_score`` take
``factor=`` and then never touch Sigma again; ``serving.cokrige_service``
builds the TLR handle.  A raw lower Cholesky factor passed as ``chol=`` is
the reference's one-release deprecation shim: it is wrapped in a dense
handle with a one-shot ``RuntimeWarning`` and Sigma is never rebuilt.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import as_tensor
from .covariance import MaternParams, build_c0, build_sigma
from .recovery import cholesky_or_nan, init_status


class CokrigingResult(NamedTuple):
    predictions: torch.Tensor  # (npred, p)
    mspe: torch.Tensor  # scalar: mean over locations of ||Zhat - Z||^2
    mspe_per_var: torch.Tensor  # (p,)


@dataclasses.dataclass(frozen=True)
class CokrigeFactor:
    """Factorized-Sigma handle on the device: factor once, predict many.

    ``kind="dense"``: ``diag_l`` is the (m, m) lower Cholesky factor of
    Sigma and u/v/ranks are None.  ``kind="tlr"``: ``diag_l`` holds the
    (T, nb, nb) factored diagonal tiles and u/v/ranks the pair-major
    strict-lower factor tiles, whose layout follows from ``n_shards``:
    every slot, or, where ``shard`` is set (a fit on a mesh), the own slots
    of the rank whose pair-shard index it is.
    """

    diag_l: torch.Tensor  # dense (m, m) factor | TLR (T, nb, nb) tiles
    u: torch.Tensor | None  # TLR (length, nb, kmax) pair-major tiles
    v: torch.Tensor | None
    ranks: torch.Tensor | None  # TLR (length,) int32
    alpha: torch.Tensor  # (m,) Sigma^{-1} z
    locs: torch.Tensor  # (n, d) observation locations
    params: MaternParams
    kind: str = "dense"  # "dense" | "tlr"
    n_shards: int = 1  # TLR pair layout shard count
    representation: str = "I"  # dense-path Sigma layout
    d_spatial: int = 2
    z: torch.Tensor | None = None  # (m,) observed data (for re-fits)
    status: object = None  # FactorStatus | None: factor health
    shard: int | None = None  # pair-shard index of own-slot u/v/ranks

    @property
    def m(self) -> int:
        return self.alpha.shape[0]


def _cho_solve(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(z[:, None], chol, upper=False)[:, 0]


def dense_factor(
    obs_locs,
    z_obs,
    params: MaternParams,
    representation: str = "I",
    nugget: float = 0.0,
    chol=None,
    *,
    device=None,
) -> CokrigeFactor:
    """Factor the dense Sigma once and wrap it as a ``CokrigeFactor``.

    ``chol`` takes an already computed lower Cholesky factor (no Sigma
    rebuild); otherwise Sigma is built and factored here.  Numpy inputs go
    to ``device`` (or to the factor's device when ``chol`` is given).
    """
    if chol is None:
        sigma = build_sigma(
            obs_locs,
            params,
            representation=representation,
            nugget=nugget,
            device=device,
        )
        chol = cholesky_or_nan(sigma)
        del sigma
    dev = chol.device
    z = as_tensor(z_obs, device=dev, dtype=chol.dtype)
    status = init_status(chol.dtype, dev).update_potrf(chol)
    return CokrigeFactor(
        diag_l=chol,
        u=None,
        v=None,
        ranks=None,
        alpha=_cho_solve(chol, z),
        locs=as_tensor(obs_locs, device=dev),
        params=params,
        kind="dense",
        representation=representation,
        z=z,
        status=status,
    )


def _chol_shim(obs_locs, z_obs, params, representation, chol) -> CokrigeFactor:
    """The one-release deprecation shim: wrap a raw ``chol=`` lower factor
    in a dense ``CokrigeFactor`` without calling ``build_sigma``."""
    from ..distribution.pair_qr import warn_fallback_once

    warn_fallback_once(
        "cokrige-chol-deprecated",
        "cokrige/cokrige_and_score: the chol= kwarg is deprecated and will "
        "be removed next release — pass factor=dense_factor(..., chol=chol) "
        "(or a serving fit_factor handle) instead",
    )
    return dense_factor(
        obs_locs, z_obs, params, representation=representation, chol=chol
    )


def cokrige(
    obs_locs,
    z_obs,
    pred_locs,
    params: MaternParams = None,
    representation: str = "I",
    nugget: float = 0.0,
    chol=None,
    factor: CokrigeFactor | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Best linear unbiased cokriging predictor at ``pred_locs``.

    Returns (npred, p) predictions for all p variables at each location.
    ``factor`` takes a precomputed ``CokrigeFactor`` (``dense_factor``, or
    ``serving.cokrige_service.fit_factor`` for the TLR path), which carries
    alpha and the observation geometry, so obs_locs, z_obs and params may
    then be None and nothing is factored again.  ``chol=`` (a raw lower
    Cholesky factor) is deprecated: it is wrapped in a dense handle with a
    one-shot warning (``_chol_shim``).
    """
    if factor is None and chol is not None:
        factor = _chol_shim(obs_locs, z_obs, params, representation, chol)
    if factor is not None:
        obs_locs, params = factor.locs, factor.params
        representation = factor.representation
        if factor.kind != "dense":
            from ..serving.cokrige_service import predict_with_factor

            return predict_with_factor(factor, pred_locs).mean
        alpha = factor.alpha
    else:
        sigma = build_sigma(
            obs_locs,
            params,
            representation=representation,
            nugget=nugget,
            device=device,
        )
        chol = cholesky_or_nan(sigma)
        del sigma
        alpha = _cho_solve(chol, as_tensor(z_obs, device=chol.device, dtype=chol.dtype))
    dev = alpha.device
    c0 = build_c0(
        as_tensor(pred_locs, device=dev),
        as_tensor(obs_locs, device=dev),
        params,
        representation=representation,
    )
    # Contract the precomputed Sigma^{-1} Z with all c0 blocks at once.
    return torch.einsum("lrp,r->lp", c0, alpha)


def mspe(pred, truth):
    """Mean square prediction error, total and per variable; (npred, p)."""
    err2 = (pred - truth) ** 2
    return torch.mean(torch.sum(err2, dim=-1)), torch.mean(err2, dim=0)


def msrp(pred, truth, eps: float = 1e-12):
    """Mean square relative prediction error (Yan & Genton 2018)."""
    rel = (pred - truth) / torch.where(torch.abs(truth) < eps, eps, truth)
    return torch.mean(rel**2)


def cokrige_and_score(
    obs_locs,
    z_obs,
    pred_locs,
    z_pred_true,
    params: MaternParams = None,
    representation: str = "I",
    nugget: float = 0.0,
    chol=None,
    factor: CokrigeFactor | None = None,
    *,
    device=None,
) -> CokrigingResult:
    """Predict and score in one call; ``factor`` and the deprecated
    ``chol=`` as for ``cokrige``."""
    if factor is None and chol is not None:
        factor = _chol_shim(obs_locs, z_obs, params, representation, chol)
    pred = cokrige(
        obs_locs,
        z_obs,
        pred_locs,
        params,
        representation=representation,
        nugget=nugget,
        factor=factor,
        device=device,
    )
    if factor is not None:
        params, representation = factor.params, factor.representation
    p = params.p
    truth = as_tensor(z_pred_true, device=pred.device, dtype=pred.dtype)
    if representation.upper() == "I":
        truth = truth.reshape(-1, p)
    else:
        truth = truth.reshape(p, -1).T
    total, per_var = mspe(pred, truth)
    return CokrigingResult(pred, total, per_var)

"""Cross-covariance matrix assembly (Section 5.2 of the paper).

Counterpart of ``repro.core.covariance``.  Builds the ``pn x pn`` matrix
Sigma(theta) of the parsimonious multivariate Matérn under the two layouts
of Fig. 3 (Representation I: variables interleaved per location;
Representation II: variable-major), one generator-direct panel of it
(``build_sigma_panel``), and the Morton (Z-order) sort of 2-D locations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..kernels import ops
from .matern import parsimonious_nu_matrix, parsimonious_rho

GENERATORS = ("kernel", "plain")


class MaternParams(NamedTuple):
    """theta for the parsimonious multivariate Matérn.

    sigma2: (p,) marginal variances sigma_ii^2
    a:      0-d spatial range
    nu:     (p,) marginal smoothnesses nu_ii
    beta:   (p, p) symmetric latent correlation matrix (diag == 1)
    """

    sigma2: torch.Tensor
    a: torch.Tensor
    nu: torch.Tensor
    beta: torch.Tensor

    @property
    def p(self) -> int:
        return self.sigma2.shape[0]

    @staticmethod
    def bivariate(
        sigma11=1.0,
        sigma22=1.0,
        a=0.1,
        nu11=0.5,
        nu22=1.0,
        beta=0.5,
        dtype=torch.float64,
        device=None,
    ):
        kw = dict(dtype=dtype, device=resolve_device(device))
        return MaternParams(
            torch.tensor([sigma11, sigma22], **kw),
            torch.tensor(a, **kw),
            torch.tensor([nu11, nu22], **kw),
            torch.tensor([[1.0, beta], [beta, 1.0]], **kw),
        )

    @staticmethod
    def trivariate(
        sigma2=(1.0, 1.0, 1.0),
        a=0.1,
        nu=(0.5, 1.0, 1.5),
        beta12=0.5,
        beta13=0.3,
        beta23=0.2,
        dtype=torch.float64,
        device=None,
    ):
        kw = dict(dtype=dtype, device=resolve_device(device))
        b = [[1.0, beta12, beta13], [beta12, 1.0, beta23], [beta13, beta23, 1.0]]
        return MaternParams(
            torch.tensor(sigma2, **kw),
            torch.tensor(a, **kw),
            torch.tensor(nu, **kw),
            torch.tensor(b, **kw),
        )

    @staticmethod
    def univariate(sigma2=1.0, a=0.1, nu=0.5, dtype=torch.float64, device=None):
        kw = dict(dtype=dtype, device=resolve_device(device))
        return MaternParams(
            torch.tensor([sigma2], **kw),
            torch.tensor(a, **kw),
            torch.tensor([nu], **kw),
            torch.ones((1, 1), **kw),
        )


def pairwise_distances(locs_a: torch.Tensor, locs_b=None) -> torch.Tensor:
    """Euclidean distances between location sets ((na, d), (nb, d))."""
    locs_b = locs_a if locs_b is None else locs_b
    d2 = torch.sum((locs_a[:, None, :] - locs_b[None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _pair_correlations(
    dists: torch.Tensor, params: MaternParams, d_spatial: int = 2
) -> torch.Tensor:
    """(p, p, *dists.shape): rho_ij * M_{nu_ij}(h / a) for every pair.

    Each order goes through ``kernels.ops.matern_correlation`` (the
    matern_corr kernel on the card; the closed form for half-integer orders
    and ``core.matern`` otherwise on the CPU); only the p(p+1)/2 distinct
    orders are evaluated, then mirrored.
    """
    p = params.p
    nu_ij = parsimonious_nu_matrix(params.nu)
    rho = parsimonious_rho(params.nu, params.beta, d=d_spatial)
    u = dists / params.a
    corr = torch.empty((p, p) + tuple(dists.shape), dtype=u.dtype, device=u.device)
    for i, j in zip(*np.triu_indices(p)):
        c = ops.matern_correlation(u, nu_ij[i, j])
        corr[i, j] = c
        corr[j, i] = c
    return rho.reshape((p, p) + (1,) * dists.dim()) * corr


def build_sigma(
    locs,
    params: MaternParams,
    representation: str = "I",
    d_spatial: int = 2,
    nugget: float | None = None,
    dists=None,
    *,
    device=None,
) -> torch.Tensor:
    """Assemble Sigma(theta) of shape (p*n, p*n).

    representation "I": entry ((l, i), (r, j)) at [l*p + i, r*p + j]
    representation "II": at [i*n + l, j*n + r]
    ``locs`` or ``dists`` may be numpy (placed on ``device``) or tensors.
    The nugget is added to the diagonal in place.
    """
    if dists is None:
        dists = pairwise_distances(as_tensor(locs, device=device))
    else:
        dists = as_tensor(dists, device=device)
    n = dists.shape[0]
    p = params.p
    sig = torch.sqrt(params.sigma2)
    amp = sig[:, None] * sig[None, :]
    blocks = amp[:, :, None, None] * _pair_correlations(dists, params, d_spatial)
    if representation.upper() == "I":
        sigma = blocks.permute(2, 0, 3, 1).reshape(n * p, n * p)
    elif representation.upper() == "II":
        sigma = blocks.permute(0, 2, 1, 3).reshape(n * p, n * p)
    else:
        raise ValueError(f"unknown representation {representation!r}")
    del blocks
    if nugget is not None:
        sigma.diagonal().add_(nugget)
    return sigma


def build_sigma_panel(
    locs_rows,
    locs_cols,
    params: MaternParams,
    d_spatial: int = 2,
    gen: str = "plain",
    *,
    device=None,
) -> torch.Tensor:
    """One Representation-I covariance panel between two location sets.

    Returns the (R*p, C*p) interleaved block whose entry
    [l*p + i, r*p + j] = C_ij(rows[l] - cols[r]): the same values as the
    matching slice of ``build_sigma``, without forming Sigma (the paper's
    GEN phase).

    ``gen="kernel"`` (the reference's ``"pallas"``, which takes only the
    half-integer orders there) generates every pair from the locations with
    ``kernels.ops.matern_tile``: the hand-written CUDA kernel for CUDA
    tensors, its plain version for CPU tensors.  ``gen="plain"`` (the
    reference's ``"xla"``) forms the distances first, then the correlation
    with ``kernels.ops.matern_correlation``.
    """
    if gen not in GENERATORS:
        raise ValueError(f"gen must be one of {GENERATORS}, got {gen!r}")
    locs_rows = as_tensor(locs_rows, device=device)
    locs_cols = as_tensor(locs_cols, device=device)
    R, C = locs_rows.shape[0], locs_cols.shape[0]
    p = params.p
    nu_ij = parsimonious_nu_matrix(params.nu)
    rho = parsimonious_rho(params.nu, params.beta, d=d_spatial)
    sig = torch.sqrt(params.sigma2)
    amp = rho * (sig[:, None] * sig[None, :])
    inv_a = 1.0 / params.a
    use_kernel = gen == "kernel" and locs_rows.shape[1] == 2
    u = None
    dtype = torch.promote_types(locs_rows.dtype, torch.float32)
    corr = torch.empty((p, p, R, C), dtype=dtype, device=locs_rows.device)
    for i, j in zip(*np.triu_indices(p)):
        if use_kernel:
            c = ops.matern_tile(locs_rows, locs_cols, inv_a, 1.0, nu=nu_ij[i, j])
        else:
            if u is None:
                u = pairwise_distances(locs_rows, locs_cols) * inv_a
            c = ops.matern_correlation(u, nu_ij[i, j])
        corr[i, j] = c
        corr[j, i] = c
    blocks = amp[:, :, None, None] * corr
    return blocks.permute(2, 0, 3, 1).reshape(R * p, C * p)


def build_sigma_column(
    locs, j: int, nbl: int, params: MaternParams, d_spatial: int = 2, gen: str = "plain"
) -> torch.Tensor:
    """One Representation-I tile-grid column panel, generator-direct: the
    (m, nb) slice ``build_sigma(locs)[:, j*nb:(j+1)*nb]`` with nb = nbl * p,
    without forming Sigma."""
    locs = as_tensor(locs)
    cols = locs[j * nbl : (j + 1) * nbl]
    return build_sigma_panel(locs, cols, params, d_spatial=d_spatial, gen=gen)


def build_c0(
    pred_locs,
    obs_locs,
    params: MaternParams,
    representation: str = "I",
    d_spatial: int = 2,
    *,
    device=None,
) -> torch.Tensor:
    """Prediction cross-covariance (Eq. 4) for a batch of prediction points.

    Returns (npred, p*n, p): c0 for each prediction location, rows ordered
    to match ``build_sigma``'s representation.
    """
    pred_locs = as_tensor(pred_locs, device=device)
    obs_locs = as_tensor(obs_locs, device=pred_locs.device)
    dists = pairwise_distances(pred_locs, obs_locs)  # (npred, n)
    p = params.p
    npred, n = dists.shape
    sig = torch.sqrt(params.sigma2)
    amp = sig[:, None] * sig[None, :]
    blocks = amp[:, :, None, None] * _pair_correlations(dists, params, d_spatial)
    # entry (i, j, l, r) = C_ij(s0_l - s_r); c0 rows follow the observations
    if representation.upper() == "I":
        return blocks.permute(2, 3, 0, 1).reshape(npred, n * p, p)
    return blocks.permute(2, 0, 3, 1).reshape(npred, n * p, p)


def build_c0_panels(
    obs_locs,
    pred_locs,
    params: MaternParams,
    *,
    nbl: int,
    d_spatial: int = 2,
    gen: str = "plain",
) -> torch.Tensor:
    """Prediction cross-covariance in tile-panel form, generator-direct.

    Returns (T, nb, B*p) with T = n // nbl and nb = nbl * p: tile t is the
    Representation-I panel between observation tile t and the whole
    prediction batch, so ``out.reshape(m, B*p)`` equals
    ``build_sigma_panel(obs_locs, pred_locs)``.  The reference maps
    ``build_sigma_panel`` over the T observation tiles; one call over all
    observations, reshaped, gives the same values.
    """
    obs_locs = as_tensor(obs_locs)
    n = obs_locs.shape[0]
    if n % nbl:
        raise ValueError(f"nbl={nbl} must divide n={n}")
    panel = build_sigma_panel(obs_locs, pred_locs, params, d_spatial=d_spatial, gen=gen)
    return panel.reshape(n // nbl, nbl * params.p, panel.shape[1])


def build_correlation_matrix(
    locs, a, nu, nugget: float | None = None, dists=None, *, device=None
) -> torch.Tensor:
    """Univariate correlation matrix R_ii(theta_i) (profile-likelihood path)."""
    if dists is None:
        dists = pairwise_distances(as_tensor(locs, device=device))
    else:
        dists = as_tensor(dists, device=device)
    r = ops.matern_correlation(dists / a, nu)
    if nugget is not None:
        r.diagonal().add_(nugget)
    return r


def cross_cov_at_zero(params: MaternParams, d_spatial: int = 2) -> torch.Tensor:
    """C(0; theta): the p x p colocated covariance."""
    rho = parsimonious_rho(params.nu, params.beta, d=d_spatial)
    sig = torch.sqrt(params.sigma2)
    return rho * (sig[:, None] * sig[None, :])


# ---------------------------------------------------------------------------
# Morton (Z-order) ordering: improves off-diagonal tile rank decay (§5.3).
# Host-side numpy, a copy of the reference's.
# ---------------------------------------------------------------------------


def _interleave_bits_u32(v: np.ndarray) -> np.ndarray:
    """Spread the lower 16 bits of v so there is a zero bit between each."""
    v = v.astype(np.uint64) & np.uint64(0xFFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
    return v


def morton_order(locs) -> np.ndarray:
    """Permutation sorting 2-D locations by Morton (Z-curve) code.

    Quantizes each coordinate to 16 bits over its range and interleaves.
    """
    if isinstance(locs, torch.Tensor):
        locs = locs.detach().cpu().numpy()
    locs = np.asarray(locs)
    if locs.ndim != 2 or locs.shape[1] != 2:
        raise ValueError(f"morton_order expects (n, 2), got {locs.shape}")
    lo = locs.min(axis=0)
    hi = locs.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip(((locs - lo) / span * 65535.0).astype(np.uint64), 0, 65535)
    code = _interleave_bits_u32(q[:, 0]) | (
        _interleave_bits_u32(q[:, 1]) << np.uint64(1)
    )
    return np.argsort(code, kind="stable")


def apply_ordering(locs, perm, *, device=None, dtype=None) -> torch.Tensor:
    """``locs[perm]`` as a tensor on ``device``."""
    if isinstance(locs, torch.Tensor):
        locs = locs.detach().cpu().numpy()
    return as_tensor(np.asarray(locs)[np.asarray(perm)], device=device, dtype=dtype)

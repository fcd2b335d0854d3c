"""Synthetic multivariate Gaussian random fields (paper §6.4.1).

Counterpart of ``repro.core.simulate``: exact samples Z = L eps with L the
Cholesky factor of Sigma(theta), on regular or uniform random locations;
the hold-out split of §4.3; and the parameters the paper reports for its
WRF datasets (Tables 1-2), for "real-data-like" fields.  The location and
split helpers are host-side numpy, copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from .covariance import MaternParams, build_sigma, morton_order


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


def split_train_pred(
    locs, z, n_pred: int, seed: int = 0, p: int = 1, representation: str = "I"
):
    """Hold out ``n_pred`` locations (all p variables missing there, §4.3).

    Returns (obs locations, their z, pred locations, their z, obs index,
    pred index); ``z`` may be numpy or a tensor (kept on its device), with
    any leading dimensions."""
    locs = np.asarray(locs)
    n = locs.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    pred_idx = np.sort(perm[:n_pred])
    obs_idx = np.sort(perm[n_pred:])
    if not isinstance(z, torch.Tensor):
        z = np.asarray(z)

    def gather(idx):
        if representation.upper() == "I":
            rows = (idx[:, None] * p + np.arange(p)[None, :]).ravel()
        else:
            rows = (np.arange(p)[:, None] * n + idx[None, :]).ravel()
        if isinstance(z, torch.Tensor):
            return z[..., torch.as_tensor(rows, device=z.device)]
        return z[..., rows]

    return (
        locs[obs_idx],
        gather(obs_idx),
        locs[pred_idx],
        gather(pred_idx),
        obs_idx,
        pred_idx,
    )


def morton_sorted_locations(locs):
    """Morton-sort locations (the paper's TLR preprocessing): (sorted, perm)."""
    perm = morton_order(locs)
    return np.asarray(locs)[perm], perm


# Parameters the paper reports for the real WRF datasets (Tables 1 and 2);
# used to synthesize "real-data-like" fields.
PAPER_TABLE1_BIVARIATE = dict(
    sigma11=0.718, sigma22=0.710, a=0.161, nu11=2.283, nu22=2.033, beta=0.192
)
PAPER_TABLE2_TRIVARIATE = dict(
    sigma2=(0.788, 0.874, 0.301),
    a=0.0822,
    nu=(1.689, 1.629, 1.234),
    beta12=0.243,
    beta13=-0.124,
    beta23=-0.059,
)


def wrf_like_params(
    kind: str = "bivariate", dtype=torch.float64, device=None
) -> MaternParams:
    """The paper's fitted WRF parameters (Table 1 or 2) as ``MaternParams``
    on ``device`` (the CUDA device by default)."""
    if kind == "bivariate":
        return MaternParams.bivariate(
            dtype=dtype, device=device, **PAPER_TABLE1_BIVARIATE
        )
    if kind == "trivariate":
        return MaternParams.trivariate(
            dtype=dtype, device=device, **PAPER_TABLE2_TRIVARIATE
        )
    raise ValueError(kind)

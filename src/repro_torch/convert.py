"""Carry the reference package's state across, as numpy arrays.

These take plain arrays (``np.asarray`` of the reference's outputs), so the
port never imports the reference.  Factoring the very TLRMatrix the
reference compressed takes the SVD sign freedom out of a comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.covariance import MaternParams
from .core.prediction import CokrigeFactor
from .core.tlr import TLRMatrix
from .device import resolve_device


def params_from_numpy(
    sigma2, a, nu, beta, *, device=None, dtype=torch.float64
) -> MaternParams:
    """``MaternParams`` from arrays: sigma2 (p,), a scalar, nu (p,), beta (p, p)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return MaternParams(t(sigma2), t(a), t(nu), t(beta))


def tlr_matrix_from_numpy(diag, u, v, ranks, *, device=None) -> TLRMatrix:
    """``TLRMatrix`` from arrays: diag (T, nb, nb), u and v (T, T, nb, kmax),
    ranks (T, T).  Floating arrays keep their dtype."""
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return TLRMatrix(t(diag), t(u), t(v), t(ranks, torch.int32))


def cokrige_factor_from_numpy(
    diag_l, u, v, ranks, alpha, locs, params, n_shards: int = 1, *, z=None, device=None
) -> CokrigeFactor:
    """A TLR ``CokrigeFactor`` from the arrays of the reference's handle:
    diag_l (T, nb, nb), u and v (length, nb, kmax) pair-major, ranks
    (length,), alpha (m,), locs (n, d); ``params`` a ``MaternParams`` or
    its four arrays (sigma2, a, nu, beta).  The reference's slots must be
    laid out for one shard, the port's single-device placement."""
    if n_shards != 1:
        raise ValueError(
            f"the port serves single-device factors, got n_shards={n_shards}"
        )
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    if not isinstance(params, MaternParams):
        params = params_from_numpy(*params, device=dev)
    return CokrigeFactor(
        diag_l=t(diag_l),
        u=t(u),
        v=t(v),
        ranks=t(ranks, torch.int32),
        alpha=t(alpha),
        locs=t(locs),
        params=params,
        kind="tlr",
        n_shards=n_shards,
        z=None if z is None else t(z),
    )

"""Carry the reference package's state across, as numpy arrays.

These take plain arrays (``np.asarray`` of the reference's outputs), so the
port never imports the reference.  Factoring the very TLRMatrix the
reference compressed takes the SVD sign freedom out of a comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.covariance import MaternParams
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

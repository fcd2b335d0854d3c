"""Numerical breakdown status of a factorization.

Counterpart of the ``FactorStatus`` / ``init_status`` / ``sentinel_loglik``
part of ``repro.core.recovery``.  The status is carried next to the factor
as 0-d tensors on its device, so reading it needs no synchronisation until
the caller asks (``ok``, ``as_dict``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device


def _big(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).max


def sentinel_loglik(dtype: torch.dtype = torch.float64) -> float:
    """Large-but-finite 'the factorization broke' log-likelihood.

    ``-sqrt(finfo.max)`` (~ -1.3e154 in f64) is far below any real loglik
    yet survives negation, subtraction and ordering without overflowing.
    The value is exactly representable in ``dtype``.
    """
    return -float(torch.sqrt(torch.tensor(_big(dtype), dtype=dtype)))


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (a batch of) SPD matrices, NaN where it fails.

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite; the reference's ``jnp.linalg.cholesky`` returns a NaN factor
    instead, which the status and the sentinel then turn into a finite
    result.  A matrix fails where a pivot is not positive or not finite
    (``cholesky_ex`` reports the first, a non-finite diagonal of its factor
    the second), the rule of the CUDA ``potrf`` kernel; no synchronisation.
    """
    lo, info = torch.linalg.cholesky_ex(a)
    piv = torch.diagonal(lo, dim1=-2, dim2=-1)
    bad = ((info != 0) | ~torch.isfinite(piv).all(-1))[..., None, None]
    return torch.where(bad, torch.full_like(lo, math.nan), lo)


class FactorStatus(NamedTuple):
    """Health of a Cholesky factorization.

    NaN pivots are sanitised to ``-finfo.max`` on entry, so every field stays
    finite even when the factor itself is garbage.
    """

    min_pivot: torch.Tensor  # smallest POTRF diagonal seen (NaN -> -max)
    nonfinite_count: torch.Tensor  # int32: non-finite recompress singular values
    breakdown_count: torch.Tensor  # int32: POTRF steps with a bad pivot

    @property
    def ok(self) -> torch.Tensor:
        return (
            (self.min_pivot > 0)
            & (self.breakdown_count == 0)
            & (self.nonfinite_count == 0)
        )

    def update_potrf(self, lkk: torch.Tensor) -> FactorStatus:
        """Fold one POTRF result ``lkk``, shape (..., nb, nb)."""
        piv = torch.diagonal(lkk, dim1=-2, dim2=-1)
        piv = torch.where(torch.isfinite(piv), piv, -_big(piv.dtype))
        worst = torch.min(piv).to(self.min_pivot.dtype)
        bad = (~(worst > 0)).to(torch.int32)
        return FactorStatus(
            torch.minimum(self.min_pivot, worst),
            self.nonfinite_count,
            self.breakdown_count + bad,
        )

    def add_nonfinite(self, count) -> FactorStatus:
        """Fold a non-finite singular-value count."""
        return self._replace(nonfinite_count=self.nonfinite_count + count)

    def merge(self, other: FactorStatus) -> FactorStatus:
        """Combine two independent status accumulations."""
        return FactorStatus(
            torch.minimum(self.min_pivot, other.min_pivot),
            self.nonfinite_count + other.nonfinite_count,
            self.breakdown_count + other.breakdown_count,
        )

    def as_dict(self) -> dict:
        """Host-side summary."""
        return {
            "ok": bool(self.ok),
            "min_pivot": float(self.min_pivot),
            "nonfinite_count": int(self.nonfinite_count),
            "breakdown_count": int(self.breakdown_count),
        }


def init_status(dtype: torch.dtype = torch.float64, device=None) -> FactorStatus:
    """Identity element for ``FactorStatus.merge``."""
    device = resolve_device(device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return FactorStatus(
        torch.tensor(_big(dtype), dtype=dtype, device=device), zero, zero.clone()
    )

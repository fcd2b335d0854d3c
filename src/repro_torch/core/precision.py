"""Dtype policies for the mixed-precision TLR path.

Counterpart of ``repro.core.precision``.  A :class:`PrecisionPolicy` names
the two dtypes of the mixed pipeline:

* **wide** sites keep the policy's wide dtype: diagonal tiles, the POTRF
  and TRSM panel solves on diagonal blocks, the logdet accumulation and
  the final log-likelihood reduction.
* **narrow** sites store and compute in the narrow dtype: off-diagonal U/V
  factors, the pair-GEMM batch and the recompress QR / core SVD.

Widening happens at exactly two boundaries, the TRSM panel solve (V cast
up in, the result cast back to storage) and the SYRK diagonal update (the
narrow product added to the wide diagonal), so a uniform policy
(``wide == narrow``) makes every cast a no-op and reproduces the path
without a policy bit for bit.

The dtypes are ``torch.dtype``s.  ``mixed_bf16`` is a policy as in the
reference; its narrow QR and SVD raise ``NotImplementedError`` where the
reference's do (``torch.linalg`` has no bfloat16 QR or SVD).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """What must stay wide and what may narrow, as two dtype names."""

    name: str
    wide: str = "float64"  # diag tiles, POTRF/TRSM, logdet, loglik
    narrow: str = "float64"  # U/V storage, pair-GEMM batch, recompress

    @property
    def wide_dtype(self) -> torch.dtype:
        return getattr(torch, self.wide)

    @property
    def narrow_dtype(self) -> torch.dtype:
        return getattr(torch, self.narrow)

    @property
    def uniform(self) -> bool:
        """True when narrowing is disabled (every cast is a no-op)."""
        return self.wide_dtype == self.narrow_dtype


POLICIES: dict[str, PrecisionPolicy] = {
    # the paper's precision: everything fp64 (the certified baseline)
    "f64": PrecisionPolicy("f64", "float64", "float64"),
    # fp32 off-diagonal storage + batched GEMM/QR/SVD, fp64 spine
    "mixed_f32": PrecisionPolicy("mixed_f32", "float64", "float32"),
    # bf16 off-diagonal tier; same fp64 spine
    "mixed_bf16": PrecisionPolicy("mixed_bf16", "float64", "bfloat16"),
}


def resolve_policy(policy) -> PrecisionPolicy | None:
    """None | name | PrecisionPolicy -> PrecisionPolicy (None passes through)."""
    if policy is None or isinstance(policy, PrecisionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise KeyError(
            f"unknown dtype policy {policy!r} "
            f"(choose from {', '.join(sorted(POLICIES))})"
        ) from None


def uv_dtype(policy, wide: torch.dtype) -> torch.dtype:
    """The storage dtype of off-diagonal U/V: the policy's narrow dtype, or
    ``wide`` (the generated dtype) without a policy."""
    policy = resolve_policy(policy)
    return wide if policy is None else policy.narrow_dtype

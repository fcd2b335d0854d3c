"""Recompression QR/SVD of the GEMM-phase pair batch, and the one-shot
fallback warning.

Counterpart of ``repro.distribution.pair_qr.sharded_recompress`` with
``mesh=None``: on one device the batch is local, so the call is
``core.tlr._batched_recompress`` (or its counting form) itself.  The
reference's ``shard_map`` form belongs to the multi-device forms (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import warnings

__all__ = ["sharded_recompress", "warn_fallback_once"]

_warned_fallbacks: set[str] = set()


def warn_fallback_once(key: str, message: str) -> None:
    """Emit one ``RuntimeWarning`` per distinct ``key`` per process (the
    reference's fallback and deprecation sites)."""
    if key not in _warned_fallbacks:
        _warned_fallbacks.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=3)


def sharded_recompress(up, vp, du, dv, tol, scale, *, mesh=None, with_count=False):
    """(length, nb, k) pair batches -> recompressed sum (U, V, ranks), plus
    with ``with_count=True`` an int32 count of non-finite core singular
    values for ``FactorStatus``.  ``mesh`` must be None."""
    from ..core.tlr import _batched_recompress, _batched_recompress_stat

    if mesh is not None:
        raise ValueError("sharded_recompress in the port is single-device: mesh=None")
    if with_count:
        return _batched_recompress_stat(up, vp, du, dv, tol, scale)
    return _batched_recompress(up, vp, du, dv, tol, scale)

"""Compression-phase truncation SVD of a batch of tiles.

Counterpart of ``repro.distribution.compress_svd.svd_truncate_batch``.  The
reference's ``shard_map`` form belongs to the multi-device forms (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import torch

__all__ = ["svd_truncate_batch"]


def svd_truncate_batch(tiles: torch.Tensor, tol, kmax: int, scale):
    """(B, nb, nb) tiles -> (U, V, ranks): batched SVD + fixed-kmax
    truncation (``core.tlr._truncate_svd``), the math every compression
    entry point runs.  A tile holding a non-finite value compresses to NaN
    factors, as in the reference, instead of raising.  The SVD runs in the
    tiles' dtype (a precision policy's narrow one when the caller cast
    them) and the threshold ``tol * scale`` is taken in that dtype, as the
    reference takes it.

    On CUDA the SVD is cuSOLVER's ``gesvd`` (QR iteration): on the 512 x 512
    float64 tiles of the main path it took 52.7 ms a tile against 90.4 ms for
    the default Jacobi ``gesvdj``, with singular values closer to the
    reference's.  The recompress cores keep the default, which was three
    times faster than ``gesvd`` there (scripts/linalg_drivers.py, H100)."""
    from ..core.tlr import _svd_or_nan, _truncate_svd

    uu, ss, vvt = _svd_or_nan(tiles, cuda_driver="gesvd")
    return _truncate_svd(uu, ss, vvt, tol, kmax, scale)

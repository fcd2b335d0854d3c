"""Compression-phase truncation SVD of a batch of tiles, split over the pair
axis of a mesh.

Counterpart of ``repro.distribution.compress_svd``.  ``svd_truncate_batch``
is the math every compression runs.  ``sharded_truncate_svd`` on a
``DeviceMesh`` has every rank SVD only its own contiguous block of the
(replicated) batch and return the whole result through one ``all_gather``,
as ``pair_qr.sharded_recompress`` does; ``mesh=None`` or empty ``axes`` is
the replicated batch.  The owned-slot compression, where a rank also
generates only its own tiles, is
``core.dist_tlr._compress_tiles_pair_sharded``.
"""

from __future__ import annotations

import torch

from .pair_qr import _check_mesh, gather_blocks, shard_blocks

__all__ = ["svd_truncate_batch", "sharded_truncate_svd"]


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


def sharded_truncate_svd(tiles, tol, kmax: int, scale, *, mesh=None, axes=None):
    """Truncation SVD of a (B, nb, nb) tile batch, each rank truncating its
    block of the batch laid out over the mesh axes ``axes``.  Returns
    (U, V, ranks) of the whole batch on every rank."""
    axes = tuple(axes) if axes else ()
    _check_mesh(mesh)
    if mesh is None or not axes:
        return svd_truncate_batch(tiles, tol, kmax, scale)
    (block,), length, shard = shard_blocks((tiles,), mesh, axes)
    return gather_blocks(svd_truncate_batch(block, tol, kmax, scale), length, shard)

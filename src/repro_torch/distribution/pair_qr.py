"""Recompression QR/SVD of the GEMM-phase pair batch, split over the pair
axis of a mesh, and the one-shot fallback warning.

Counterpart of ``repro.distribution.pair_qr``.  The recompression (concat
the update pair, QR both factors, SVD the small core, truncate) is a purely
per-pair batch.  ``sharded_recompress`` with ``mesh=None`` or empty ``axes``
is ``core.tlr._batched_recompress`` (or its counting form) itself.  On a
``DeviceMesh`` every rank passes the whole batch, as the reference's
single controller does, QRs and SVDs only its own contiguous block of it
(the reference's ``P(axes)`` split of the leading axis: shard d of S, the
rank's coordinate flattened over ``axes``, takes block d; mesh axes left
out of ``axes`` hold copies of the blocks, as the reference replicates over
them), and gets the whole result back through one ``all_gather``; a
non-finite count is summed over the ranks (``all_reduce``), each slot
counted once, by the first copy of its shard.  A batch length the shard count does not
divide is zero-padded and stripped after (``pad_leading``: zero slots
factorize to zeros); ``pad=False`` instead runs the replicated batch on
every rank with a one-time ``RuntimeWarning`` (``warn_fallback_once``),
the reference's contract.

The TLR panel steps do not call the mesh form: a rank there holds only its
own slots already, and recompresses them with ``mesh=None``
(``core.tlr.tlr_panel_body_bc``).
"""

from __future__ import annotations

import math
import warnings

import torch

__all__ = [
    "pair_shard_count",
    "pad_leading",
    "warn_fallback_once",
    "sharded_recompress",
]

_warned_fallbacks: set[str] = set()


def pair_shard_count(mesh, axes) -> int:
    """Ranks the pair axis spans: the product of the given mesh axes."""
    if mesh is None or not axes:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return math.prod(int(sizes[a]) for a in axes)


def pad_leading(arrays, multiple: int):
    """Zero-pad every tensor's leading axis to the next multiple.

    Returns ``(padded, length)`` with ``length`` the original leading size:
    slice ``[:length]`` after the sharded call to strip the pads.
    """
    n = arrays[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return tuple(arrays), n
    return (
        tuple(
            torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in arrays
        ),
        n,
    )


def warn_fallback_once(key: str, message: str) -> None:
    """Emit one ``RuntimeWarning`` per distinct ``key`` per process (the
    reference's fallback and deprecation sites)."""
    if key not in _warned_fallbacks:
        _warned_fallbacks.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=3)


def _check_mesh(mesh) -> None:
    """Refuse a mesh that is not a named ``DeviceMesh``."""
    if mesh is not None:
        from .block_cyclic import pair_axis

        pair_axis(mesh)


def shard_blocks(arrays, mesh, axes):
    """This rank's block of each tensor's leading axis on the mesh axes
    ``axes``, after zero-padding to a multiple of the shard count; mesh axes
    outside ``axes`` hold copies (the reference's replication over them).

    Returns ``(blocks, length, shard)``: ``length`` is the unpadded size and
    ``shard`` the rank's ``block_cyclic.PairShard`` over ``axes``.
    """
    from .block_cyclic import _pair_shard

    _check_mesh(mesh)
    shard = _pair_shard(mesh, tuple(axes))
    padded, length = pad_leading(arrays, shard.count)
    per = padded[0].shape[0] // shard.count
    lo = shard.index * per
    return tuple(a[lo : lo + per] for a in padded), length, shard


def gather_blocks(blocks, length: int, shard):
    """The whole leading axis from every shard's block, pads stripped."""
    return tuple(torch.cat(shard.gather(b))[:length] for b in blocks)


def sharded_recompress(
    up, vp, du, dv, tol, scale, *, mesh=None, axes=None, pad: bool = True,
    with_count: bool = False,
):
    """(length, nb, k) pair batches -> recompressed sum (U, V, ranks), each
    rank factorizing only its block of the pair axis laid out over the mesh
    axes ``axes``; with ``with_count=True`` a fourth int32 scalar, the
    non-finite core singular values summed over all ranks."""
    from ..core.tlr import _batched_recompress, _batched_recompress_stat

    local = _batched_recompress_stat if with_count else _batched_recompress
    axes = tuple(axes) if axes else ()
    _check_mesh(mesh)
    if mesh is None or not axes:
        return local(up, vp, du, dv, tol, scale)
    shards = pair_shard_count(mesh, axes)
    length = up.shape[0]
    if length % shards and not pad:
        warn_fallback_once(
            "recompress-indivisible",
            f"sharded_recompress: pair batch length {length} is not divisible "
            f"by {shards} shards and pad=False: every rank recompresses the "
            "whole batch (a per-rank memory cliff); pad the batch or fix the "
            "layout",
        )
        return local(up, vp, du, dv, tol, scale)
    blocks, length, shard = shard_blocks((up, vp, du, dv), mesh, axes)
    out = local(*blocks, tol, scale)
    un, vn, rn = gather_blocks(out[:3], length, shard)
    if not with_count:
        return un, vn, rn
    bad = shard.sum(out[3].reshape(1).clone())[0]
    return un, vn, rn, bad

"""Pair-major placement of the strict-lower TLR tile pairs.

Counterpart of ``repro.distribution.block_cyclic`` (its layout and the two
converters), a numpy copy: the port imports nothing of the reference.  The
strict-lower pairs are enumerated column-major, (1,0), (2,0), ...,
(T-1,0), (2,1), ..., so the pairs of one tile column are consecutive, and
enumeration index q is dealt to slot ``(q % S) * pairs_per_shard + q // S``
for S shards.  On one device S = 1 and the slot is q itself.  The list is
zero-padded to a multiple of S with (0, 0) entries, which fail the
strict-lower predicate ``il > jl``.

``pos[i, j]`` is the slot of pair (i, j) and ``length`` (one past the end)
elsewhere, as in the reference; the port never indexes with that sentinel.
It reads a column's pairs through ``pos[k+1:, k]``, the rows below the
diagonal only (``core.tlr.tlr_panel_body_bc``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PairLayout", "pair_layout", "pair_shards", "grid_to_pairs", "pairs_to_grid"]


class PairLayout(NamedTuple):
    """Static (numpy) description of one block-cyclic pair placement."""

    n_tiles: int
    n_shards: int
    pairs_per_shard: int
    il: np.ndarray  # (length,) int32 row tile index; pads are (0, 0)
    jl: np.ndarray  # (length,) int32 col tile index
    pos: np.ndarray  # (T, T) int32 slot of pair (i, j); `length` elsewhere

    @property
    def length(self) -> int:
        return int(self.il.shape[0])

    @property
    def n_pairs(self) -> int:
        return self.n_tiles * (self.n_tiles - 1) // 2

    @property
    def valid(self) -> np.ndarray:
        return self.il > self.jl


@functools.lru_cache(maxsize=None)
def pair_layout(n_tiles: int, n_shards: int = 1) -> PairLayout:
    """Block-cyclic layout of the strict-lower pairs of a (T, T) tile grid."""
    if n_tiles < 1 or n_shards < 1:
        raise ValueError(f"need n_tiles, n_shards >= 1, got {(n_tiles, n_shards)}")
    jj, ii = np.meshgrid(np.arange(n_tiles), np.arange(n_tiles), indexing="ij")
    keep = ii > jj
    ei, ej = ii[keep], jj[keep]  # sorted by j, then i
    n_pairs = len(ei)
    pairs_per_shard = max(-(-n_pairs // n_shards), 1)
    length = pairs_per_shard * n_shards
    il = np.zeros(length, np.int32)
    jl = np.zeros(length, np.int32)
    q = np.arange(n_pairs)
    slot = (q % n_shards) * pairs_per_shard + q // n_shards
    il[slot] = ei
    jl[slot] = ej
    pos = np.full((n_tiles, n_tiles), length, np.int32)
    pos[ei, ej] = slot
    return PairLayout(
        n_tiles=n_tiles, n_shards=n_shards, pairs_per_shard=pairs_per_shard,
        il=il, jl=jl, pos=pos,
    )


def pair_shards(mesh=None, row_axes=("data",)) -> int:
    """Number of shards the pair axis spans: 1 without a mesh.  The port
    runs on one device, so a mesh raises."""
    if mesh is not None:
        raise ValueError(
            "mesh is not ported: the port's TLR forms run on one device "
            "(ROADMAP Queue 1 item 7, the multi-device forms); pass mesh=None"
        )
    return 1


def grid_to_pairs(x: torch.Tensor, layout: PairLayout) -> torch.Tensor:
    """(T, T, ...) strict-lower grid -> (length, ...) pair-major tensor.

    Pads read grid[0, 0], which is zero in strict-lower storage.
    """
    il = torch.as_tensor(layout.il, dtype=torch.long, device=x.device)
    jl = torch.as_tensor(layout.jl, dtype=torch.long, device=x.device)
    return x[il, jl]


def pairs_to_grid(xp: torch.Tensor, layout: PairLayout) -> torch.Tensor:
    """(length, ...) pair-major tensor -> (T, T, ...) grid, zeros outside
    the strict lower triangle."""
    T = layout.n_tiles
    keep = np.nonzero(layout.valid)[0]
    out = torch.zeros((T, T) + tuple(xp.shape[1:]), dtype=xp.dtype, device=xp.device)
    dev = xp.device
    out[
        torch.as_tensor(layout.il[keep], dtype=torch.long, device=dev),
        torch.as_tensor(layout.jl[keep], dtype=torch.long, device=dev),
    ] = xp[torch.as_tensor(keep, device=dev)]
    return out

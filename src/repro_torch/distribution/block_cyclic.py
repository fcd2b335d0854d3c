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

On a ``DeviceMesh`` (``launch.mesh``) the pair axis spans every row axis and
"model" (``pair_shards``, ``pair_axis``); a rank's pair-shard index is its
mesh coordinate flattened over ``pair_axis`` (first axis slowest), and shard
d owns the global slots ``d * pairs_per_shard + q`` (``PairShard``).  The
static tables ``column_owner_tables``, ``owned_pair_tables`` and
``slice_positions`` are numpy copies of the reference's.  On a mesh with
an axis outside the pair axis (the multi-pod mesh's "pod" axis where
``row_axes`` leave it out) every rank along that axis holds a copy of its
shard, as the reference replicates over it; ``PairShard.sum`` counts each
shard once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "PairLayout",
    "PairShard",
    "pair_layout",
    "pair_shards",
    "pair_axis",
    "pair_shard",
    "gather_pairs",
    "grid_to_pairs",
    "pairs_to_grid",
    "slice_positions",
    "column_owner_tables",
    "owned_pair_tables",
]


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
    """Number of shards the pair axis spans: every row axis and "model" (the
    pair list is 1-D, so the whole mesh can split it); 1 without a mesh."""
    shard = pair_shard(mesh, row_axes)
    return 1 if shard is None else shard.count


def pair_axis(mesh, row_axes=("data",)):
    """The mesh axes the pair axis is laid out over, in order (None off-mesh)."""
    if mesh is None:
        return None
    names = _mesh_names(mesh)
    if "model" in tuple(row_axes):
        raise ValueError(
            f"row_axes={tuple(row_axes)!r}: 'model' always closes the pair axis"
        )
    return tuple(a for a in tuple(row_axes) + ("model",) if a in names)


def _mesh_names(mesh) -> tuple:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            f"mesh must be a torch.distributed DeviceMesh (launch.mesh), got "
            f"{type(mesh).__name__}"
        )
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("mesh must name its dims, as ('data', 'model')")
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class PairShard:
    """This rank's place on the pair axis of a mesh.

    ``index`` is the rank's pair-shard index d (its coordinate flattened over
    ``axes``, the first axis slowest), ``ranks[d]`` the global rank of shard
    d, and ``group`` the process group the pair axis spans (the mesh's, which
    must be the whole process group).  Shard d owns the global pair slots
    ``d * pairs_per_shard + q``.  Where ``axes`` leave mesh axes out (a
    "pod" axis that ``row_axes`` leave out, as in the reference's multi-pod
    mesh), every rank along those axes holds a copy of its shard and
    computes what the copy computes: ``ranks[d]`` is the first copy,
    ``primary`` says whether this rank is its shard's, and ``sum`` counts
    each shard once.

    The shard order follows ``axes``, not the mesh's dim order, so the
    collectives of every form reassemble parts through ``gather`` and
    ``gather_rows``, which put them in shard order.
    """

    axes: tuple
    count: int
    index: int
    ranks: tuple
    group: object
    primary: bool = True

    def owns(self, layout: PairLayout) -> slice:
        """This shard's slots of ``layout`` (built for ``count`` shards)."""
        pps = layout.pairs_per_shard
        return slice(self.index * pps, (self.index + 1) * pps)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the shards of their ``t``, in place (one
        ``all_reduce``): a copy of a shard adds zeros, so each shard counts
        once."""
        from ..launch.mesh import all_reduce_

        if not self.primary:
            t.zero_()
        return all_reduce_(t, group=self.group)

    def gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every shard's ``t`` (one shape on every rank), in shard order
        (one ``all_gather``)."""
        from ..launch.mesh import all_gather

        parts = all_gather(t, self.group)
        return [parts[r] for r in self.ranks]

    def gather_rows(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        """Every shard's ``t``, whose leading size may differ from shard to
        shard, zero-padded to ``rows`` and stacked in shard order:
        (count, rows, ...) (one ``all_gather``)."""
        from ..launch.mesh import all_gather_rows

        parts = all_gather_rows(t, rows, self.group)
        if self.ranks == tuple(range(parts.shape[0])):
            return parts
        return parts[torch.as_tensor(self.ranks, device=parts.device)]


@functools.lru_cache(maxsize=None)
def _pair_shard(mesh, axes: tuple) -> PairShard:
    """This rank's ``PairShard`` over the mesh axes ``axes``.  Every rank
    along a mesh axis outside ``axes`` holds a copy of its shard (the
    reference replicates over it)."""
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    unknown = [a for a in axes if a not in names]
    if unknown:
        raise ValueError(f"axes {unknown} are not axes of the mesh {names}")
    outside = [a for a in names if a not in axes]
    world = dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError(
            f"the mesh holds {mesh.mesh.numel()} ranks of {world}: it must span all"
        )
    order = [names.index(a) for a in axes + tuple(outside)]
    count = math.prod(int(mesh.mesh.shape[names.index(a)]) for a in axes)
    grid = mesh.mesh.permute(*order).reshape(count, -1)
    index, copy = (int(i) for i in torch.nonzero(grid == dist.get_rank())[0])
    return PairShard(
        axes=axes,
        count=count,
        index=index,
        ranks=tuple(int(r) for r in grid[:, 0].tolist()),
        group=dist.group.WORLD,
        primary=copy == 0,
    )


def pair_shard(mesh, row_axes=("data",)) -> PairShard | None:
    """This rank's ``PairShard`` on ``mesh`` (None without a mesh).

    Raises ``ValueError`` for an object that is not a named ``DeviceMesh``.
    A mesh axis outside the pair axis (a "pod" axis that ``row_axes`` leave
    out) holds copies of the shards, as the reference replicates over it.
    """
    if mesh is None:
        return None
    return _pair_shard(mesh, pair_axis(mesh, row_axes))


def gather_pairs(x: torch.Tensor, shard: PairShard | None) -> torch.Tensor:
    """The full (length, ...) pair-major tensor from every shard's own
    (pairs_per_shard, ...) slots (``all_gather``); ``x`` itself without a
    shard."""
    if shard is None or shard.count == 1:
        return x
    return torch.cat(shard.gather(x))


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


@functools.lru_cache(maxsize=None)
def _column_owner_tables(n_tiles: int, n_shards: int):
    layout = pair_layout(n_tiles, n_shards)
    T, S, pps = layout.n_tiles, layout.n_shards, layout.pairs_per_shard
    per_col = max(-(-(T - 1) // S), 1)
    rows = np.full((S, T, per_col), T, np.int32)
    slots = np.full((S, T, per_col), pps, np.int32)
    counts = np.zeros((S, T), np.int32)
    for s in np.nonzero(layout.valid)[0]:
        i, j = int(layout.il[s]), int(layout.jl[s])
        d, local = s // pps, s % pps
        rows[d, j, counts[d, j]] = i
        slots[d, j, counts[d, j]] = local
        counts[d, j] += 1
    return rows, slots


def column_owner_tables(layout: PairLayout):
    """Per-shard, per-column slot ownership of the block-cyclic deal.

    Returns ``(rows, slots)``, int32 arrays of shape (S, T, L) with
    L = ceil((T-1)/S): ``rows[d, j]`` lists the strict-lower row tiles i of
    column j whose pair slot shard d owns, in increasing order, and
    ``slots[d, j]`` the matching shard-local slots.  Every shard owns
    floor or ceil((T-1-j)/S) of column j's pairs.  Unused entries carry the
    sentinels row ``T`` and local slot ``pairs_per_shard``.
    """
    return _column_owner_tables(layout.n_tiles, layout.n_shards)


@functools.lru_cache(maxsize=None)
def _owned_pair_tables(n_tiles: int, n_shards: int):
    layout = pair_layout(n_tiles, n_shards)
    T, S, pps = layout.n_tiles, layout.n_shards, layout.pairs_per_shard
    valid = layout.valid
    rows = np.where(valid, layout.il, T).astype(np.int32).reshape(S, pps)
    cols = np.where(valid, layout.jl, T).astype(np.int32).reshape(S, pps)
    return rows, cols


def owned_pair_tables(layout: PairLayout):
    """Per-shard (row, col) tile indices of the owned pairs, slot-major.

    Returns ``(rows, cols)``, int32 arrays of shape (S, pairs_per_shard):
    the tile (i, j) at shard d's local slot q (global slot
    d * pairs_per_shard + q), with the sentinel row = col = ``T`` at pads.
    """
    return _owned_pair_tables(layout.n_tiles, layout.n_shards)


def slice_positions(outer: PairLayout, inner: PairLayout, offset: int) -> np.ndarray:
    """Slot map for trailing-submatrix slicing: inner slot q holds the pair
    at outer slot ``src[q]`` (pair (i + offset, j + offset)); ``outer.length``
    at inner pads."""
    src = np.full(inner.length, outer.length, np.int32)
    keep = inner.valid
    src[keep] = outer.pos[inner.il[keep] + offset, inner.jl[keep] + offset]
    return src

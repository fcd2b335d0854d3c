"""Distributed-TLR likelihood forms, on one device or on a device mesh.

Counterpart of ``repro.core.dist_tlr``.  Two placements of the strict-lower
UV tiles, as in the reference:

  * the masked (T, T) grid (``TLRMatrix``): ``dist_tlr_cholesky`` and
    ``dist_tlr_solve_lower``;
  * block-cyclic pair-major storage (``PairTLR``,
    ``distribution.block_cyclic``): a (length, nb, kmax) leading axis read a
    tile column at a time through ``layout.pos[k+1:, k]``, the path
    cokriging serving runs (``serving.cokrige_service``).

``dist_compress_tiles`` fills either from the Matérn generator (``col_block``
columns to one SVD batch, U/V at a ``dtype_policy``'s narrow dtype), and
``dist_tlr_loglik`` runs compress -> factorize -> forward solve -> Eq. 1 in
either placement, with ``super_panels`` super-steps.

The reference's masked full-grid batch and its unrolled super-panel trace
exist to give XLA static shapes; the port runs eagerly and its panel
bodies already touch only the live trailing tiles (``tlr.tlr_panel_body``),
so every form here drives the same in-place panel loops
(``tlr.factorize``) and returns what the reference returns for that form,
without the reference's masked overcompute.

**On a mesh** (``mesh=`` a ``DeviceMesh``, ``launch.mesh``; one process a
rank) the pair layout is ``pair_layout(T, S)`` for the S ranks of the pair
axis, and a rank's share is its ``PairShard``'s slots:

  * ``dist_compress_tiles`` with ``shard_svd`` generates and SVDs only the
    rank's own pair tiles (``_compress_tiles_pair_sharded``); the diagonal
    tiles are generated on every rank.  In pair mode the ``PairTLR`` comes
    back holding the rank's own slots (``shard`` set); in grid mode every
    rank gathers the whole grid.  ``shard_svd=False`` compresses the whole
    matrix on every rank.
  * ``dist_tlr_cholesky_pairs`` with ``shard_recompress`` factors the rank's
    own slots (``tlr.tlr_panel_body_bc`` with ``shard_axes``: one
    ``all_gather`` of column k a panel step) and returns them; the diagonal
    tiles, their POTRF and SYRK are replicated, and the status's non-finite
    count is summed over the ranks (``all_reduce``).  ``shard_recompress=
    False`` factors the whole layout on every rank.
  * The masked grid form (``dist_tlr_cholesky``, ``block_cyclic=False``)
    shares the same work the same way: the grid is dealt into the
    block-cyclic pair slots, each rank factors its own, and every rank
    gathers the grid factor back.  (The reference instead keeps the grid
    sharded 2-D and masks; ROADMAP Queue 3.)
  * Whether raw pair tensors hold a rank's own slots is said, never
    guessed: a ``PairTLR``'s ``shard``, and ``own_slots=True`` on the
    factorization and the pair solves.  The pair solves on a rank's own
    slots do one ``all_reduce`` a tile row (the partial sums of the rank's
    tiles), and every rank solves the diagonal tiles; the solution comes
    back whole on every rank, as do the loglik, its parts and the status.
    ``gather_pairs`` reassembles a factor's slots (tests).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import as_tensor
from ..distribution.block_cyclic import (
    PairLayout,
    PairShard,
    column_owner_tables,
    gather_pairs,
    grid_to_pairs,
    pair_layout,
    pair_shard,
    pairs_to_grid,
)
from ..distribution.compress_svd import svd_truncate_batch
from ..distribution.pair_qr import warn_fallback_once
from ..kernels import ops
from .covariance import MaternParams, build_sigma_panel
from .likelihood import LoglikResult
from .precision import uv_dtype
from .tlr import (
    TLRMatrix,
    _lap,
    _loglik_of,
    _put,
    _sub,
    choose_tile_size,
    compress_columns,
    diag_tiles,
    factorize,
    fill_grid,
    index_of,
    pair_panel_loop,
    panel_loop,
    solve_lower_grid,
)


@dataclasses.dataclass(frozen=True)
class PairTLR:
    """TLR matrix with strict-lower tiles in pair-major storage.

    The slot order follows from (n_tiles, n_shards) through
    ``pair_layout``, so the shard count the tiles were placed for travels
    with them.  ``shard`` is None when u/v/ranks hold every slot, else the
    pair-shard index d of the rank whose own ``pairs_per_shard`` slots they
    hold (global slots ``d * pairs_per_shard + q``; a mesh form's output).
    """

    diag: torch.Tensor  # (T, nb, nb) dense diagonal tiles
    u: torch.Tensor  # (length, nb, kmax) pair-major strict-lower tiles
    v: torch.Tensor  # (length, nb, kmax)
    ranks: torch.Tensor  # (length,) int32 actual ranks (0 at pad slots)
    n_shards: int = 1
    shard: int | None = None

    @property
    def n_tiles(self) -> int:
        return self.diag.shape[0]

    @property
    def tile_size(self) -> int:
        return self.diag.shape[1]

    @property
    def max_rank(self) -> int:
        return self.u.shape[-1]

    @property
    def shape(self):
        m = self.n_tiles * self.tile_size
        return (m, m)

    def to_grid(self, layout: PairLayout) -> TLRMatrix:
        """The (T, T) grid form (tests and interop only) of a PairTLR that
        holds every slot."""
        if self.shard is not None:
            raise ValueError("gather the shards first (gather_pair_tlr)")
        return TLRMatrix(
            diag=self.diag,
            u=pairs_to_grid(self.u, layout),
            v=pairs_to_grid(self.v, layout),
            ranks=pairs_to_grid(self.ranks, layout),
        )


def gather_pair_tlr(t: PairTLR, mesh, row_axes=("data",)) -> PairTLR:
    """A ``PairTLR`` holding every slot, on every rank, from one that holds
    a rank's own slots (``all_gather``); ``t`` itself if it holds them all."""
    if t.shard is None:
        return t
    shard = pair_shard(mesh, row_axes)
    parts = (gather_pairs(x, shard) for x in (t.u, t.v, t.ranks))
    return PairTLR(t.diag, *parts, n_shards=t.n_shards)


def _placed(mesh, row_axes, own_slots: bool) -> PairShard | None:
    """The rank's ``PairShard`` (None off-mesh); ``own_slots`` (pair tensors
    that hold a rank's own slots) needs a mesh."""
    shard = pair_shard(mesh, row_axes)
    if own_slots and shard is None:
        raise ValueError("own_slots=True needs the mesh whose slots the tensors hold")
    return shard


def _slots_of(
    x: torch.Tensor, layout: PairLayout, shard: PairShard, own_slots: bool
) -> torch.Tensor:
    """This rank's slots of a pair-major tensor: ``x`` itself where it holds
    them (``own_slots``), else its share of every slot."""
    if layout.n_shards != shard.count:
        raise ValueError(
            f"layout is for n_shards={layout.n_shards} but the mesh's pair axis "
            f"spans {shard.count} ranks; build it with pair_shards(mesh, row_axes)"
        )
    want = layout.pairs_per_shard if own_slots else layout.length
    if x.shape[0] != want:
        held = "a rank's own slots" if own_slots else "every slot"
        raise ValueError(
            f"pair tensor of {x.shape[0]} slots holding {held}: the layout has "
            f"{want}"
        )
    return x if own_slots else x[shard.owns(layout)]


def dist_compress_tiles(
    locs,
    params: MaternParams,
    *,
    tile_size: int = 0,
    tol: float = 1e-7,
    max_rank: int = 0,
    nugget: float = 0.0,
    gen: str = "kernel",
    d_spatial: int = 2,
    scale=None,
    mesh=None,
    row_axes=("data",),
    layout: PairLayout | None = None,
    col_block: int = 1,
    shard_svd: bool = True,
    dtype_policy=None,
    device=None,
    times: dict | None = None,
):
    """Generator-direct compression of Morton-ordered locations into the
    fixed-kmax D/U/V layout: a ``TLRMatrix`` grid with ``layout=None``, else
    a ``PairTLR`` whose slot ``layout.pos[i, j]`` holds tile (i, j).

    ``col_block`` columns share one truncation-SVD batch and must divide T,
    as in the reference.  The reference generates each whole column panel,
    SVDs all T of its tiles and masks the rows i <= j; here only the T-1-j
    strict-lower tiles of column j are generated and SVD'd
    (``tlr.compress_columns``), the same values at about half the SVD work.
    ``dtype_policy`` casts those tiles to the policy's narrow dtype before
    the SVD and stores U/V narrow; diagonal tiles stay wide.  ``scale``
    defaults to max(sigma2) + nugget.

    On a mesh with ``shard_svd`` each rank generates and SVDs only the pair
    tiles it owns (``_compress_tiles_pair_sharded``): the pair form holds
    the rank's own slots, the grid form is gathered on every rank.  A
    ``layout`` built for another shard count than the mesh's pair axis
    compresses the whole matrix on every rank, with a one-time warning, as
    in the reference.
    """
    shard = pair_shard(mesh, row_axes)
    if shard is not None and shard_svd:
        m = len(locs) * params.p
        T = m // choose_tile_size(m, tile_size, multiple_of=params.p)
        if layout is None or layout.n_shards == shard.count:
            own = _compress_tiles_pair_sharded(
                locs,
                params,
                layout=layout or pair_layout(T, shard.count),
                shard=shard,
                tile_size=tile_size,
                tol=tol,
                max_rank=max_rank,
                nugget=nugget,
                gen=gen,
                d_spatial=d_spatial,
                scale=scale,
                col_block=col_block,
                dtype_policy=dtype_policy,
                device=device,
                times=times,
            )
            if layout is not None:
                return own
            grid = pair_layout(T, shard.count)
            parts = (gather_pairs(x, shard) for x in (own.u, own.v, own.ranks))
            return TLRMatrix(own.diag, *(pairs_to_grid(x, grid) for x in parts))
        warn_fallback_once(
            "compress-layout-shards",
            f"dist_compress_tiles: layout was built for n_shards={layout.n_shards} "
            f"but the mesh's pair axis spans {shard.count} ranks: every rank "
            "compresses the whole matrix; build the layout with "
            "pair_shards(mesh, row_axes)",
        )
    diag, kmax, store, columns = compress_columns(
        locs,
        params,
        tile_size,
        tol,
        max_rank,
        nugget,
        gen,
        d_spatial,
        scale,
        col_block=col_block,
        dtype_policy=dtype_policy,
        device=device,
        times=times,
    )
    if layout is None:
        return fill_grid(diag, kmax, store, columns)
    T, nb = diag.shape[0], diag.shape[1]
    if layout.n_tiles != T:
        raise ValueError(f"layout is for {layout.n_tiles} tiles, the matrix has {T}")
    dev = diag.device
    u = torch.zeros((layout.length, nb, kmax), dtype=store, device=dev)
    v = torch.zeros_like(u)
    ranks = torch.zeros((layout.length,), dtype=torch.int32, device=dev)
    for j, U, V, R in columns:
        col = index_of(layout.pos[j + 1 :, j], dev)
        u[col] = U
        v[col] = V
        ranks[col] = R
    return PairTLR(diag=diag, u=u, v=v, ranks=ranks, n_shards=layout.n_shards)


def _compress_tiles_pair_sharded(
    locs,
    params: MaternParams,
    *,
    layout: PairLayout,
    shard: PairShard,
    tile_size,
    tol,
    max_rank,
    nugget,
    gen,
    d_spatial,
    scale,
    col_block,
    dtype_policy,
    device,
    times,
) -> PairTLR:
    """Owned-slot generator-direct compression: this rank generates and
    SVD-truncates only the strict-lower tiles whose block-cyclic slots it
    owns, straight into its own (pairs_per_shard, nb, kmax) slots.

    Column j's owned tiles (``column_owner_tables``: floor or
    ceil((T-1-j)/S) of them) come from one generator call over their row
    blocks against block j, and ``col_block`` columns share one SVD batch,
    so a rank generates exactly its owned set and nothing else.  Each
    tile's values are the single-device form's (the generator is
    elementwise in the location pairs, the SVD per tile).  The diagonal
    tiles are generated on every rank, with the nugget.
    """
    locs = as_tensor(locs, device=device)
    p = params.p
    m = locs.shape[0] * p
    nb = choose_tile_size(m, tile_size, multiple_of=p)
    nbl, T = nb // p, m // nb
    if layout.n_tiles != T:
        raise ValueError(f"layout is for {layout.n_tiles} tiles, the matrix has {T}")
    cb = max(int(col_block), 1)
    if T % cb:
        raise ValueError(f"col_block={cb} must divide n_tiles={T}")
    kmax = min(max_rank if max_rank > 0 else max(8, nb // 4), nb)
    if scale is None:
        scale = torch.max(params.sigma2) + nugget
    t0 = _lap(times, None, 0.0, params.sigma2)
    blocks = [locs[t * nbl : (t + 1) * nbl] for t in range(T)]
    diag = diag_tiles(blocks, params, nugget, gen, d_spatial)
    store = uv_dtype(dtype_policy, diag.dtype)
    dev = diag.device
    pps = layout.pairs_per_shard
    u = torch.zeros((pps, nb, kmax), dtype=store, device=dev)
    v = torch.zeros_like(u)
    ranks = torch.zeros((pps,), dtype=torch.int32, device=dev)
    rows, slots = (x[shard.index] for x in column_owner_tables(layout))
    offsets = np.arange(nbl)
    group, dst = [], []
    for j in range(T - 1):
        keep = rows[j] < T
        if keep.any():
            idx = (rows[j][keep][:, None] * nbl + offsets).reshape(-1)
            panel = build_sigma_panel(
                locs[torch.as_tensor(idx, device=dev)],
                blocks[j],
                params,
                d_spatial=d_spatial,
                gen=gen,
            )
            group.append(panel.reshape(-1, nb, nb))
            dst.append(slots[j][keep])
        if group and ((j + 1) % cb == 0 or j == T - 2):
            t0 = _lap(times, "gen", t0, group[-1])
            batch = torch.cat(group).to(store)
            U, V, R = svd_truncate_batch(batch, tol, kmax, scale)
            at = torch.as_tensor(np.concatenate(dst), device=dev)
            u[at], v[at], ranks[at] = U, V, R
            t0 = _lap(times, "compress", t0, u)
            group, dst = [], []
    _lap(times, "gen", t0, diag)
    return PairTLR(diag, u, v, ranks, n_shards=layout.n_shards, shard=shard.index)


def dist_tlr_cholesky(
    diag,
    u,
    v,
    ranks=None,
    *,
    tol: float = 1e-7,
    scale=1.0,
    mesh=None,
    row_axes=("data",),
    super_panels: int = 1,
    block_cyclic: bool = False,
    shard_recompress: bool = True,
    track_status: bool = False,
    times: dict | None = None,
):
    """Factor the TLR matrix: the grid API, (T, T) grid tiles in and
    ``(diag_L, u, v, ranks)`` out in the grid layout, plus a
    ``FactorStatus`` with ``track_status=True``.

    ``ranks=None`` starts from zero rank metadata, as in the reference.
    ``block_cyclic=True`` converts the grid to pair-major storage once,
    factors it there (``dist_tlr_cholesky_pairs``) and converts back.
    ``super_panels = S`` runs S super-steps (``_tlr_cholesky_super``).  The
    inputs are not modified.  On a mesh both forms factor the block-cyclic
    pair slots, each rank its own, and every rank gathers the grid factor
    (``shard_recompress`` applies to ``block_cyclic=True`` only, as in the
    reference).
    """
    shard = pair_shard(mesh, row_axes)
    if ranks is None:
        ranks = torch.zeros(u.shape[:2], dtype=torch.int32, device=u.device)
    if block_cyclic or shard is not None:
        layout = pair_layout(diag.shape[0], 1 if shard is None else shard.count)
        split = shard_recompress or not block_cyclic
        out = dist_tlr_cholesky_pairs(
            diag,
            grid_to_pairs(u, layout),
            grid_to_pairs(v, layout),
            grid_to_pairs(ranks, layout),
            layout=layout,
            tol=tol,
            scale=scale,
            mesh=mesh,
            row_axes=row_axes,
            super_panels=super_panels,
            shard_recompress=split,
            track_status=track_status,
            times=times,
        )
        pairs = out[1:4]
        if shard is not None and split:  # the factor holds the rank's own slots
            pairs = (gather_pairs(x, shard) for x in pairs)
        grid = (out[0],) + tuple(pairs_to_grid(x, layout) for x in pairs)
        return grid + (out[4],) if track_status else grid
    return _tlr_cholesky_super(
        diag,
        u,
        v,
        ranks,
        tol=tol,
        scale=scale,
        super_panels=super_panels,
        track_status=track_status,
        times=times,
    )


def dist_tlr_cholesky_pairs(
    diag,
    up,
    vp,
    ranks,
    *,
    layout: PairLayout,
    tol: float = 1e-7,
    scale=1.0,
    mesh=None,
    row_axes=("data",),
    super_panels: int = 1,
    shard_recompress: bool = True,
    own_slots: bool = False,
    track_status: bool = False,
    times: dict | None = None,
):
    """Pair-native TLR Cholesky: (diag, U, V, ranks) in pair-major storage
    in, the factor in the same storage out, never the (T, T) grid.

    The panel steps (``tlr.pair_panel_loop``) update a copy of the inputs
    in place, in ``super_panels`` super-steps
    (``_tlr_cholesky_super_pairs``).
    Returns ``(diag_L, u, v, ranks)``, plus a ``FactorStatus`` with
    ``track_status=True``.  On a mesh the pair tensors hold every slot, or,
    with ``own_slots=True``, the rank's own ones (a mesh compression's
    ``PairTLR``), and ``layout`` must be built for the mesh's pair axis.
    With ``shard_recompress`` the rank's own slots come back, else every
    slot; the diagonal tiles and the status are whole on every rank.
    """
    shard = _placed(mesh, row_axes, own_slots)
    split = shard is not None and shard_recompress
    pairs = (up, vp, ranks)
    if own_slots or split:
        pairs = tuple(_slots_of(x, layout, shard, own_slots) for x in pairs)
    if own_slots and not split:  # the replicated factorization takes every slot
        pairs = tuple(gather_pairs(x, shard) for x in pairs)
    up, vp, ranks = pairs
    if not split:
        shard = None
    return _tlr_cholesky_super_pairs(
        diag,
        up,
        vp,
        ranks,
        layout=layout,
        tol=tol,
        scale=scale,
        super_panels=super_panels,
        track_status=track_status,
        times=times,
        mesh=mesh if shard is not None else None,
        shard=shard,
    )


def _tlr_cholesky_super(
    diag, u, v, ranks, *, tol, scale, super_panels: int, track_status, times
):
    """The masked-grid factorization in ``super_panels`` super-steps of
    T / S panels each (T must be a multiple of S; S = 1 is the single-level
    loop), one ``FactorStatus`` per super-step, merged (min pivot, summed
    counts), as the reference's two-level form merges its slices'.

    The reference factors a shrinking trailing slice in each super-step so
    that its masked batch spans only the live tiles.  The port's panel body
    touches only the live tiles at every step, so a super-step here is a
    run of the one in-place loop over the full buffers: no slices are
    copied, and the values are the single-level form's.
    """
    loop = functools.partial(panel_loop, tol=tol, scale=scale)
    return factorize(
        loop,
        diag,
        u,
        v,
        ranks,
        super_panels=super_panels,
        track_status=track_status,
        times=times,
    )


def _tlr_cholesky_super_pairs(
    diag,
    up,
    vp,
    ranks,
    *,
    layout,
    tol,
    scale,
    super_panels: int,
    track_status,
    times,
    mesh=None,
    shard: PairShard | None = None,
):
    """The block-cyclic factorization in super-steps, as
    ``_tlr_cholesky_super`` on pair-major storage.  The reference remaps the
    live pairs into a fresh, smaller ``PairLayout`` each super-step; the
    port's pair body reads only the live slots of the one layout at every
    step, so no remap is needed and the values are the single-level
    form's.  With a ``shard`` the slots are the rank's own, and the status's
    non-finite count is summed over the ranks at the end."""
    if diag.shape[0] != layout.n_tiles:
        raise ValueError(
            f"layout is for {layout.n_tiles} tiles, diag has {diag.shape[0]}"
        )
    loop = functools.partial(
        pair_panel_loop,
        layout=layout,
        tol=tol,
        scale=scale,
        mesh=mesh,
        shard_axes=None if shard is None else shard.axes,
    )
    out = factorize(
        loop,
        diag,
        up,
        vp,
        ranks,
        super_panels=super_panels,
        track_status=track_status,
        times=times,
    )
    if shard is None or not track_status:
        return out
    status = out[4]
    count = shard.sum(status.nonfinite_count.reshape(1).clone())
    return out[:4] + (status._replace(nonfinite_count=count[0]),)


def _rhs(z, T: int, nb: int):
    """(m,) or (m, r) right-hand side as a (T, nb, r) copy, and whether it
    was a single vector."""
    single = z.dim() == 1
    r = 1 if single else z.shape[1]
    return z.reshape(T, nb, r).clone(), single


def _own_columns(layout: PairLayout, shard: PairShard, device):
    """For each tile column k, the row tiles i > k and the local slots of
    this rank's pairs (i, k) (``column_owner_tables``), as index tensors."""
    rows, slots = (x[shard.index] for x in column_owner_tables(layout))
    T = layout.n_tiles
    out = []
    for k in range(T):
        keep = rows[k] < T
        out.append(
            (
                torch.as_tensor(rows[k][keep], dtype=torch.long, device=device),
                index_of(slots[k][keep], device),
            )
        )
    return out


def _solve_lower_own(diag_l, up, vp, z, *, layout, shard, z_partial: bool = False):
    """Forward substitution on a rank's own pair slots.

    Each rank keeps the partial sums of its own tiles' updates to every
    tile row; step k sums row k's over the ranks (one ``all_reduce`` of an
    (nb, r) block), every rank solves the diagonal tile (``trsm``) and
    applies its own tiles of column k.  With ``z_partial`` the right-hand
    side is itself a sum over the ranks (each row held by one), summed in
    the same ``all_reduce``.  Returns the (T, nb, r) solution, whole on
    every rank.
    """
    T = diag_l.shape[0]
    cols = _own_columns(layout, shard, up.device)
    acc = torch.zeros_like(z)
    out = torch.empty_like(z)
    for k in range(T):
        part = z[k] - acc[k] if z_partial else -acc[k]
        part = shard.sum(part.clone())
        rhs = part if z_partial else z[k] + part
        wk = ops.trsm(diag_l[k : k + 1], rhs[None])[0]
        out[k] = wk
        rows, slots = cols[k]
        if len(rows):
            uk, vk = up[slots].to(z.dtype), vp[slots].to(z.dtype)
            acc[rows] += uk @ (vk.mT @ wk)
    return out


def dist_tlr_solve_lower_pairs(
    diag_l, up, vp, z, *, layout: PairLayout, mesh=None, row_axes=("data",),
    own_slots: bool = False,
):
    """Forward substitution L w = z on pair-major storage.

    ``z`` may be (m,) or (m, r): the r right-hand sides (a serving c0 panel
    batch) share the one sweep over the factor.  Step k solves the diagonal
    tile with the ``trsm`` kernel and subtracts U_ik (V_ik^T w_k) from the
    rows i > k, whose tiles it reads through ``pos[k+1:, k]``.  In place
    on a copy of z, or into new tensors while autograd records the inputs.
    On a mesh, a factor of the rank's own slots (``own_slots=True``, the
    mesh factorization's output) is solved there (``_solve_lower_own``);
    ``z`` is whole on every rank, and so is w.
    """
    T, nb = diag_l.shape[0], diag_l.shape[1]
    shard = _placed(mesh, row_axes, own_slots)
    z, single = _rhs(z, T, nb)
    if own_slots:
        up, vp = (_slots_of(x, layout, shard, True) for x in (up, vp))
        out = _solve_lower_own(diag_l, up, vp, z, layout=layout, shard=shard)
        return out.reshape(-1) if single else out.reshape(T * nb, -1)
    fresh = ops.records_grad(diag_l, up, vp, z)
    out = torch.empty_like(z)
    for k in range(T):
        wk = ops.trsm(diag_l[k : k + 1], z[k : k + 1])
        out = _put(out, k, wk[0], fresh)
        if k + 1 < T:
            col = index_of(layout.pos[k + 1 :, k], z.device)
            # narrow U/V (a mixed policy) widened, as the reference's einsum
            # promotes them
            vk, uk = vp[col].to(z.dtype), up[col].to(z.dtype)
            # (T-1-k, nb, r)
            z = _sub(z, slice(k + 1, T), uk @ (vk.mT @ wk), fresh)
    return out.reshape(-1) if single else out.reshape(T * nb, -1)


def dist_tlr_solve_upper_pairs(
    diag_l, up, vp, y, *, layout: PairLayout, mesh=None, row_axes=("data",),
    own_slots: bool = False,
):
    """Backward substitution L^T x = y on pair-major storage (the second
    solve of alpha = Sigma^{-1} z).

    Row k of L^T x reads L_kk^T x_k + sum_{i>k} V_ik U_ik^T x_i, the
    transposed column-k tiles, read through the same slots as the forward
    sweep.  The diagonal solve with L_kk^T stays
    ``torch.linalg.solve_triangular``: the reference computes it outside
    any Pallas kernel, and the TPU ``trsm`` has no transposed form.  Same
    (m,) or (m, r) convention as the forward solve.  On a mesh, with a
    factor of the rank's own slots (``own_slots=True``), each rank sums its
    own tiles of column k and one ``all_reduce`` a step adds the ranks'
    sums; x is whole on every rank.
    """
    T, nb = diag_l.shape[0], diag_l.shape[1]
    shard = _placed(mesh, row_axes, own_slots)
    cols = None
    if own_slots:
        up, vp = (_slots_of(x, layout, shard, True) for x in (up, vp))
        cols = _own_columns(layout, shard, up.device)
    fresh = ops.records_grad(diag_l, up, vp, y)
    y, single = _rhs(y, T, nb)
    out = torch.zeros_like(y) if own_slots else torch.empty_like(y)
    for k in range(T - 1, -1, -1):
        rhs = y[k]
        if own_slots:
            rows, slots = cols[k]
            part = torch.zeros_like(rhs)
            if len(rows):
                uk, vk = up[slots].to(y.dtype), vp[slots].to(y.dtype)
                part = (vk @ (uk.mT @ out[rows])).sum(0)
            rhs = rhs - shard.sum(part)
        elif k + 1 < T:
            col = index_of(layout.pos[k + 1 :, k], y.device)
            uk, vk = up[col].to(y.dtype), vp[col].to(y.dtype)
            wu = uk.mT @ out[k + 1 :]  # (T-1-k, kmax, r)
            rhs = rhs - (vk @ wu).sum(0)
        xk = torch.linalg.solve_triangular(diag_l[k].mT, rhs, upper=True)
        out = _put(out, k, xk, fresh)
    return out.reshape(-1) if single else out.reshape(T * nb, -1)


def dist_tlr_solve_lower(diag_l, u, v, z) -> torch.Tensor:
    """Forward substitution L alpha = z with the grid-form TLR factor: the
    single-device ``tlr.solve_lower_grid``, as in the reference."""
    return solve_lower_grid(diag_l, u, v, z)


def dist_tlr_loglik(
    t=None,
    z=None,
    *,
    locs=None,
    params: MaternParams | None = None,
    from_tiles: bool = False,
    tile_size: int = 0,
    max_rank: int = 64,
    nugget: float = 0.0,
    gen: str = "kernel",
    d_spatial: int = 2,
    tol: float = 1e-7,
    scale=None,
    mesh=None,
    row_axes=("data",),
    super_panels: int = 1,
    block_cyclic: bool = False,
    layout: PairLayout | None = None,
    col_block: int = 1,
    shard_recompress: bool = True,
    shard_svd: bool = True,
    track_status: bool = True,
    dtype_policy=None,
    device=None,
    times: dict | None = None,
) -> LoglikResult:
    """TLR likelihood (Eq. 1) through the distributed forms.

    Two entry modes:

      * ``dist_tlr_loglik(t, z)`` factors pre-compressed tiles (a
        ``TLRMatrix``, or a ``PairTLR``, which forces ``block_cyclic``).
      * ``dist_tlr_loglik(None, z, locs=..., params=..., from_tiles=True)``
        generates and compresses the tiles first (``dist_compress_tiles``,
        never the dense Sigma); ``scale`` then defaults to
        max(sigma2) + nugget, else to 1.

    ``block_cyclic=True`` keeps the evaluation pair-native (compression
    straight into pair-major storage, pair factorization and forward
    sweep).  An explicit ``layout`` must cover the tile grid, and match a
    ``PairTLR``'s shard count (ValueError otherwise).  ``track_status``
    (default on) gives a ``status`` on the result and the finite sentinel
    loglik on breakdown.  ``dtype_policy`` stores U/V narrow during the
    from-tiles compression; the factorization widens at the TRSM and SYRK
    boundaries and the logdet stays wide.  Numpy ``locs`` and ``z`` go to
    ``device``; ``times`` collects the phase seconds.

    On a mesh the layout is built for the mesh's pair axis, ``shard_svd``
    and ``shard_recompress`` split the compression and the factorization
    over the ranks (see the module docstring), and the result is whole on
    every rank.
    """
    shard = pair_shard(mesh, row_axes)
    n_shards = 1 if shard is None else shard.count
    if isinstance(t, PairTLR):
        block_cyclic = True
    if from_tiles:
        if locs is None or params is None:
            raise ValueError("from_tiles=True requires locs and params")
        if scale is None:
            scale = torch.max(params.sigma2) + nugget
        if not block_cyclic:
            layout = None
        else:
            m = len(locs) * params.p
            nb = choose_tile_size(m, tile_size, multiple_of=params.p)
            if layout is None:
                layout = pair_layout(m // nb, n_shards)
            elif layout.n_tiles != m // nb:
                raise ValueError(
                    f"layout covers n_tiles={layout.n_tiles} "
                    f"but the tile grid has {m // nb}"
                )
        t = dist_compress_tiles(
            locs,
            params,
            tile_size=tile_size,
            tol=tol,
            max_rank=max_rank,
            nugget=nugget,
            gen=gen,
            d_spatial=d_spatial,
            scale=scale,
            mesh=mesh,
            row_axes=row_axes,
            layout=layout,
            col_block=col_block,
            shard_svd=shard_svd,
            dtype_policy=dtype_policy,
            device=device,
            times=times,
        )
    elif t is None:
        raise ValueError(
            "pass a TLRMatrix/PairTLR, or locs/params with from_tiles=True"
        )
    if scale is None:
        scale = 1.0
    if block_cyclic:
        if isinstance(t, PairTLR):
            if layout is None:
                layout = pair_layout(t.n_tiles, t.n_shards)
            elif layout.n_shards != t.n_shards:
                raise ValueError(
                    f"PairTLR was scattered for n_shards={t.n_shards} but "
                    f"layout has n_shards={layout.n_shards}; slot orders differ"
                )
        else:
            if layout is None:
                layout = pair_layout(t.n_tiles, n_shards)
            t = PairTLR(
                diag=t.diag,
                u=grid_to_pairs(t.u, layout),
                v=grid_to_pairs(t.v, layout),
                ranks=grid_to_pairs(t.ranks, layout),
                n_shards=layout.n_shards,
            )
    kw = dict(
        tol=tol,
        scale=scale,
        mesh=mesh,
        row_axes=row_axes,
        super_panels=super_panels,
        shard_recompress=shard_recompress,
        track_status=track_status,
        times=times,
    )
    if block_cyclic:
        out = dist_tlr_cholesky_pairs(
            t.diag, t.u, t.v, t.ranks, layout=layout, own_slots=t.shard is not None,
            **kw,
        )
    else:
        out = dist_tlr_cholesky(t.diag, t.u, t.v, t.ranks, **kw)
    diag_l, u, v = out[:3]
    status = out[4] if track_status else None
    t0 = _lap(times, None, 0.0, diag_l)
    zt = as_tensor(z, device=diag_l.device, dtype=diag_l.dtype)
    if block_cyclic:
        alpha = dist_tlr_solve_lower_pairs(
            diag_l, u, v, zt, layout=layout, mesh=mesh, row_axes=row_axes,
            own_slots=shard is not None and shard_recompress,
        )
    else:
        alpha = dist_tlr_solve_lower(diag_l, u, v, zt)
    res = _loglik_of(diag_l, alpha, t.shape[0], status=status)
    _lap(times, "solve", t0, res.loglik)
    return res

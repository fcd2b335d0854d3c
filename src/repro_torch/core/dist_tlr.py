"""Distributed-TLR likelihood forms on one device.

Counterpart of ``repro.core.dist_tlr`` with ``mesh=None``.  Two placements
of the strict-lower UV tiles, as in the reference:

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
without the reference's masked overcompute.  ``mesh`` must be None
(``pair_shards``); on one device ``row_axes``, ``shard_svd`` and
``shard_recompress`` select nothing, as in the reference with
``mesh=None``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..device import as_tensor
from ..distribution.block_cyclic import (
    PairLayout,
    grid_to_pairs,
    pair_layout,
    pair_shards,
    pairs_to_grid,
)
from ..kernels import ops
from .covariance import MaternParams
from .likelihood import LoglikResult
from .tlr import (
    TLRMatrix,
    _lap,
    _loglik_of,
    _put,
    _sub,
    choose_tile_size,
    compress_columns,
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
    with them.
    """

    diag: torch.Tensor  # (T, nb, nb) dense diagonal tiles
    u: torch.Tensor  # (length, nb, kmax) pair-major strict-lower tiles
    v: torch.Tensor  # (length, nb, kmax)
    ranks: torch.Tensor  # (length,) int32 actual ranks (0 at pad slots)
    n_shards: int = 1

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
        """The (T, T) grid form (tests and interop only)."""
        return TLRMatrix(
            diag=self.diag,
            u=pairs_to_grid(self.u, layout),
            v=pairs_to_grid(self.v, layout),
            ranks=pairs_to_grid(self.ranks, layout),
        )


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
    """
    pair_shards(mesh, row_axes)
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
    inputs are not modified.
    """
    pair_shards(mesh, row_axes)
    if ranks is None:
        ranks = torch.zeros(u.shape[:2], dtype=torch.int32, device=u.device)
    if block_cyclic:
        layout = pair_layout(diag.shape[0], 1)
        out = dist_tlr_cholesky_pairs(
            diag,
            grid_to_pairs(u, layout),
            grid_to_pairs(v, layout),
            grid_to_pairs(ranks, layout),
            layout=layout,
            tol=tol,
            scale=scale,
            super_panels=super_panels,
            track_status=track_status,
            times=times,
        )
        grid = (out[0],) + tuple(pairs_to_grid(x, layout) for x in out[1:4])
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
    track_status: bool = False,
    times: dict | None = None,
):
    """Pair-native TLR Cholesky: (diag, U, V, ranks) in pair-major storage
    in, the factor in the same storage out, never the (T, T) grid.

    The panel steps (``tlr.pair_panel_loop``) update a copy of the inputs
    in place, in ``super_panels`` super-steps
    (``_tlr_cholesky_super_pairs``).
    Returns ``(diag_L, u, v, ranks)``, plus a ``FactorStatus`` with
    ``track_status=True``.
    """
    pair_shards(mesh, row_axes)
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
    diag, up, vp, ranks, *, layout, tol, scale, super_panels: int, track_status, times
):
    """The block-cyclic factorization in super-steps, as
    ``_tlr_cholesky_super`` on pair-major storage.  The reference remaps the
    live pairs into a fresh, smaller ``PairLayout`` each super-step; the
    port's pair body reads only the live slots of the one layout at every
    step, so no remap is needed and the values are the single-level
    form's."""
    if diag.shape[0] != layout.n_tiles:
        raise ValueError(
            f"layout is for {layout.n_tiles} tiles, diag has {diag.shape[0]}"
        )
    loop = functools.partial(pair_panel_loop, layout=layout, tol=tol, scale=scale)
    return factorize(
        loop,
        diag,
        up,
        vp,
        ranks,
        super_panels=super_panels,
        track_status=track_status,
        times=times,
    )


def _rhs(z, T: int, nb: int):
    """(m,) or (m, r) right-hand side as a (T, nb, r) copy, and whether it
    was a single vector."""
    single = z.dim() == 1
    r = 1 if single else z.shape[1]
    return z.reshape(T, nb, r).clone(), single


def dist_tlr_solve_lower_pairs(diag_l, up, vp, z, *, layout: PairLayout):
    """Forward substitution L w = z on pair-major storage.

    ``z`` may be (m,) or (m, r): the r right-hand sides (a serving c0 panel
    batch) share the one sweep over the factor.  Step k solves the diagonal
    tile with the ``trsm`` kernel and subtracts U_ik (V_ik^T w_k) from the
    rows i > k, whose tiles it reads through ``pos[k+1:, k]``.  In place
    on a copy of z, or into new tensors while autograd records the inputs.
    """
    T, nb = diag_l.shape[0], diag_l.shape[1]
    fresh = ops.records_grad(diag_l, up, vp, z)
    z, single = _rhs(z, T, nb)
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


def dist_tlr_solve_upper_pairs(diag_l, up, vp, y, *, layout: PairLayout):
    """Backward substitution L^T x = y on pair-major storage (the second
    solve of alpha = Sigma^{-1} z).

    Row k of L^T x reads L_kk^T x_k + sum_{i>k} V_ik U_ik^T x_i, the
    transposed column-k tiles, read through the same slots as the forward
    sweep.  The diagonal solve with L_kk^T stays
    ``torch.linalg.solve_triangular``: the reference computes it outside
    any Pallas kernel, and the TPU ``trsm`` has no transposed form.  Same
    (m,) or (m, r) convention as the forward solve.
    """
    T, nb = diag_l.shape[0], diag_l.shape[1]
    fresh = ops.records_grad(diag_l, up, vp, y)
    y, single = _rhs(y, T, nb)
    out = torch.empty_like(y)
    for k in range(T - 1, -1, -1):
        rhs = y[k]
        if k + 1 < T:
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
    """TLR likelihood (Eq. 1) through the distributed forms, on one device.

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
    """
    pair_shards(mesh, row_axes)
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
                layout = pair_layout(m // nb, 1)
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
            layout=layout,
            col_block=col_block,
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
                layout = pair_layout(t.n_tiles, 1)
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
        super_panels=super_panels,
        track_status=track_status,
        times=times,
    )
    if block_cyclic:
        out = dist_tlr_cholesky_pairs(t.diag, t.u, t.v, t.ranks, layout=layout, **kw)
    else:
        out = dist_tlr_cholesky(t.diag, t.u, t.v, t.ranks, **kw)
    diag_l, u, v = out[:3]
    status = out[4] if track_status else None
    t0 = _lap(times, None, 0.0, diag_l)
    zt = as_tensor(z, device=diag_l.device, dtype=diag_l.dtype)
    if block_cyclic:
        alpha = dist_tlr_solve_lower_pairs(diag_l, u, v, zt, layout=layout)
    else:
        alpha = dist_tlr_solve_lower(diag_l, u, v, zt)
    res = _loglik_of(diag_l, alpha, t.shape[0], status=status)
    _lap(times, "solve", t0, res.loglik)
    return res


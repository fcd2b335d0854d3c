"""Pair-major TLR factorization and solves (single device).

Counterpart of the pair-native path of ``repro.core.dist_tlr`` with
``mesh=None``, ``col_block=1`` and ``super_panels=1``: the strict-lower
tiles live in pair-major storage (``distribution.block_cyclic``), a
(length, nb, kmax) leading axis instead of the (T, T) grid, and the
factorization and both triangular sweeps read a tile column through its
slots ``layout.pos[k+1:, k]``.  This is the path cokriging serving runs
(``serving.cokrige_service``).  The sharded, masked-grid and super-panel
forms, and the knobs that select them (``mesh``, ``col_block``,
``super_panels``, ``shard_recompress``), belong to the multi-device slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..distribution.block_cyclic import PairLayout, pairs_to_grid
from ..kernels import ops
from .covariance import MaternParams
from .recovery import init_status
from .tlr import TLRMatrix, _lap, compress_columns, index_of, pair_panel_loop


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
    layout: PairLayout,
    device=None,
    times: dict | None = None,
) -> PairTLR:
    """Generator-direct compression into pair-major storage: the reference's
    ``layout=`` (pair) mode with ``mesh=None`` and ``col_block=1``.

    Returns a ``PairTLR`` whose slot ``layout.pos[i, j]`` holds tile (i, j).
    The reference generates each whole column panel, SVDs all T of its
    tiles and masks the rows i <= j; here only the T-1-j strict-lower tiles
    of column j are generated and SVD'd (``tlr.compress_columns``), which
    gives the same values at about half the SVD work.  Locations must be
    Morton-ordered by the caller.
    """
    diag, kmax, columns = compress_columns(
        locs,
        params,
        tile_size,
        tol,
        max_rank,
        nugget,
        gen,
        d_spatial,
        scale,
        device=device,
        times=times,
    )
    T, nb = diag.shape[0], diag.shape[1]
    if layout.n_tiles != T:
        raise ValueError(f"layout is for {layout.n_tiles} tiles, the matrix has {T}")
    dev = diag.device
    u = torch.zeros((layout.length, nb, kmax), dtype=diag.dtype, device=dev)
    v = torch.zeros_like(u)
    ranks = torch.zeros((layout.length,), dtype=torch.int32, device=dev)
    for j, U, V, R in columns:
        col = index_of(layout.pos[j + 1 :, j], dev)
        u[col] = U
        v[col] = V
        ranks[col] = R
    return PairTLR(diag=diag, u=u, v=v, ranks=ranks, n_shards=layout.n_shards)


def dist_tlr_cholesky_pairs(
    diag,
    up,
    vp,
    ranks,
    *,
    layout: PairLayout,
    tol: float = 1e-7,
    scale=1.0,
    track_status: bool = False,
    times: dict | None = None,
):
    """Pair-native TLR Cholesky: (diag, U, V, ranks) in pair-major storage
    in, the factor in the same storage out, never the (T, T) grid (the
    reference's form with ``mesh=None`` and ``super_panels=1``).

    The inputs are cloned once; the panel steps (``tlr.pair_panel_loop``)
    then update the copy in place, and the last tile needs only its POTRF
    (the ``potrf`` kernel).  Returns ``(diag_L, u, v, ranks)``, plus a
    ``FactorStatus`` with ``track_status=True``.
    """
    T = diag.shape[0]
    diag, up, vp, ranks = (x.clone() for x in (diag, up, vp, ranks))
    t0 = _lap(times, None, 0.0, diag)
    status = init_status(diag.dtype, diag.device) if track_status else None
    out = pair_panel_loop(
        diag, up, vp, ranks, T - 1, layout=layout, tol=tol, scale=scale, status=status
    )
    lkk = ops.potrf(diag[T - 1 :])
    diag[T - 1] = lkk[0]
    _lap(times, "factorize", t0, diag)
    if track_status:
        return diag, up, vp, ranks, out[4].update_potrf(lkk)
    return diag, up, vp, ranks


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
    rows i > k, whose tiles it reads through ``pos[k+1:, k]``.
    """
    T, nb = diag_l.shape[0], diag_l.shape[1]
    z, single = _rhs(z, T, nb)
    out = torch.empty_like(z)
    for k in range(T):
        wk = ops.trsm(diag_l[k : k + 1], z[k : k + 1])
        out[k] = wk[0]
        if k + 1 < T:
            col = index_of(layout.pos[k + 1 :, k], z.device)
            t = vp[col].mT @ wk  # (T-1-k, kmax, r)
            z[k + 1 :] -= up[col] @ t
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
    y, single = _rhs(y, T, nb)
    out = torch.empty_like(y)
    for k in range(T - 1, -1, -1):
        rhs = y[k]
        if k + 1 < T:
            col = index_of(layout.pos[k + 1 :, k], y.device)
            wu = up[col].mT @ out[k + 1 :]  # (T-1-k, kmax, r)
            rhs = rhs - (vp[col] @ wu).sum(0)
        out[k] = torch.linalg.solve_triangular(diag_l[k].mT, rhs, upper=True)
    return out.reshape(-1) if single else out.reshape(T * nb, -1)

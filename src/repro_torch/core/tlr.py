"""Tile Low-Rank (TLR) covariance computations (§5.3 of the paper).

Counterpart of ``repro.core.tlr`` (its single-device, grid-form path).  The
matrix is split into T x T tiles of size nb.  Diagonal tiles stay dense;
each strict-lower tile A[i, j] is stored as U V^T with rank k(i, j) set by
the accuracy threshold (TLR5/TLR7/TLR9 <-> 1e-5/1e-7/1e-9), zero-padded to
a fixed kmax columns, in (T, T, nb, kmax) U and V arrays.

The main path, ``tlr_loglik(from_tiles=True)``, runs

    GEN        tiles straight from the Matérn generator (``generate_tiles``;
               every order through the ``matern_tile`` kernel)
    compress   truncated SVD of each strict-lower column panel
    factorize  right-looking TLR Cholesky, per panel step POTRF, TRSM, SYRK
               (the ``tlr_mm`` kernel) and GEMM + QR/SVD recompression
    solve      forward substitution and the log-determinant

and never forms the dense Sigma.  PyTorch runs eagerly, so the reference's
``lax.scan`` panel loops are Python loops over a concrete step index, and
each step touches only the live rows and pairs (see ``tlr_panel_body``).
The factorization clones its input once and then updates in place.

Given a ``times`` dict, ``tlr_loglik`` and the functions under it add the
wall-clock seconds of each phase (``gen``, ``compress``, ``factorize``,
``solve``) to it, synchronising the device at every phase boundary.

``dtype_policy`` (``core.precision``) stores the off-diagonal U/V, and runs
their truncation SVD, GEMM and recompression, in the policy's narrow dtype;
diagonal tiles, POTRF, TRSM, the logdet and the loglik stay wide.  The
factorization follows the storage dtypes and widens at two boundaries only
(``tlr_panel_body``).
"""

from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_tensor
from ..distribution.block_cyclic import (
    _pair_shard,
    column_owner_tables,
    owned_pair_tables,
    pair_axis,
)
from ..distribution.compress_svd import svd_truncate_batch
from ..distribution.pair_qr import sharded_recompress
from ..kernels import ops
from .covariance import MaternParams, build_sigma, build_sigma_panel
from .likelihood import LoglikResult
from .precision import uv_dtype
from .recovery import FactorStatus, init_status, sentinel_loglik


def _lap(times: dict | None, key: str | None, t0: float, like) -> float:
    """Add the seconds since ``t0`` to ``times[key]`` once the device that
    holds ``like`` is idle, and return the new start; no-op without times."""
    if times is None:
        return t0
    if isinstance(like, torch.Tensor) and like.device.type == "cuda":
        torch.cuda.synchronize(like.device)
    now = time.perf_counter()
    if key is not None:
        times[key] = times.get(key, 0.0) + (now - t0)
    return now


class TLRMatrix(NamedTuple):
    """Symmetric positive-definite matrix in TLR form (lower storage).

    ``u``/``v`` always carry kmax columns; columns at index >= ranks[i, j]
    are zero.  All compute runs on the padded layout; ``ranks`` is
    reporting metadata (memory_footprint / rank_distribution).
    """

    diag: torch.Tensor  # (T, nb, nb) dense diagonal tiles
    u: torch.Tensor  # (T, T, nb, kmax); [i, j] valid for i > j
    v: torch.Tensor  # (T, T, nb, kmax)
    ranks: torch.Tensor  # (T, T) int32 actual ranks (0 outside strict lower)

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


def choose_tile_size(m: int, target: int = 0, multiple_of: int = 1) -> int:
    """nb = O(sqrt(m)) per the paper's complexity trade-off, rounded to a
    divisor of m that is a multiple of ``multiple_of``."""
    if multiple_of > 1 and m % multiple_of:
        raise ValueError(f"m={m} not divisible by multiple_of={multiple_of}")
    if target <= 0:
        target = max(32, int(math.sqrt(m)) // 32 * 32 or 32)
    if 0 < target <= m and m % target == 0 and target % multiple_of == 0:
        return target
    divisors = []
    i = 1
    while i * i <= m:
        if m % i == 0:
            divisors.append(i)
            divisors.append(m // i)
        i += 1
    best, best_gap = None, None
    for nb in sorted(divisors):  # ascending: ties resolve to the smaller nb
        if nb % multiple_of:
            continue
        gap = abs(nb - target)
        if best is None or gap < best_gap:
            best, best_gap = nb, gap
    if best is None:
        raise ValueError(
            f"choose_tile_size: no divisor of m={m} is a multiple of "
            f"multiple_of={multiple_of} (target={target}); pass a tile size "
            "that divides m, or fix m/multiple_of"
        )
    return best


def _threshold(tol, scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tol * scale, dtype=like.dtype, device=like.device)


def _svd_or_nan(a: torch.Tensor, cuda_driver: str | None = None):
    """Reduced SVD of a batch; a member holding a non-finite value gets NaN
    factors, as ``jnp.linalg.svd`` gives, where ``torch.linalg.svd`` would
    raise.  No synchronisation: the check is a mask on the device.

    ``cuda_driver`` names the cuSOLVER method for CUDA input (None: PyTorch's
    default, Jacobi ``gesvdj``); it is ignored on the CPU."""
    finite = torch.isfinite(a).all(-1).all(-1)
    driver = cuda_driver if a.is_cuda else None
    safe = torch.where(finite[..., None, None], a, 0.0)
    u, s, vt = torch.linalg.svd(safe, full_matrices=False, driver=driver)
    bad = ~finite
    return (
        torch.where(bad[..., None, None], math.nan, u),
        torch.where(bad[..., None], math.nan, s),
        torch.where(bad[..., None, None], math.nan, vt),
    )


def _truncate_svd(u, s, vt, tol: float, kmax: int, scale):
    """Zero-pad a (batched) truncated SVD to kmax columns; (U, V, rank)."""
    k = s.shape[-1]
    keep = s > _threshold(tol, scale, s)
    rank = torch.clamp(keep.sum(-1), max=kmax)
    kk = min(k, kmax)
    mask = torch.arange(kk, device=s.device) < rank[..., None]
    uu = u[..., :kk] * torch.where(mask, s[..., :kk], 0.0)[..., None, :]
    vv = torch.where(mask[..., None, :], vt[..., :kk, :].mT, 0.0)
    pad = kmax - kk
    if pad > 0:
        uu = torch.nn.functional.pad(uu, (0, pad))
        vv = torch.nn.functional.pad(vv, (0, pad))
    return uu, vv, rank.to(torch.int32)


def tlr_compress(
    sigma: torch.Tensor,
    tile_size: int = 0,
    tol: float = 1e-7,
    max_rank: int = 0,
    scale=None,
    multiple_of: int = 1,
    dtype_policy=None,
) -> TLRMatrix:
    """Compress a dense SPD matrix to TLR (validation path).

    ``dtype_policy`` stores the off-diagonal U/V (and runs their truncation
    SVD) in the policy's narrow dtype; diagonal tiles keep sigma's dtype.
    """
    m = sigma.shape[0]
    nb = choose_tile_size(m, tile_size, multiple_of=multiple_of)
    T = m // nb
    if max_rank <= 0:
        max_rank = max(8, nb // 4)
    kmax = min(max_rank, nb)
    if scale is None:
        scale = torch.max(torch.abs(torch.diagonal(sigma)))
    tiles = sigma.reshape(T, nb, T, nb).transpose(1, 2)  # (T, T, nb, nb)
    diag = torch.stack([tiles[t, t] for t in range(T)])
    kw = dict(dtype=uv_dtype(dtype_policy, sigma.dtype), device=sigma.device)
    u = torch.zeros((T, T, nb, kmax), **kw)
    v = torch.zeros((T, T, nb, kmax), **kw)
    ranks = torch.zeros((T, T), dtype=torch.int32, device=sigma.device)
    il, jl = np.tril_indices(T, k=-1)
    if len(il):
        low = tiles[il, jl].to(kw["dtype"])
        U, V, R = svd_truncate_batch(low, tol, kmax, scale)
        u[il, jl] = U
        v[il, jl] = V
        ranks[il, jl] = R
    return TLRMatrix(diag=diag, u=u, v=v, ranks=ranks)


def apply_nugget(diag_tiles: torch.Tensor, nugget, dtype=None) -> torch.Tensor:
    """Nugget on (..., nb, nb) diagonal tiles (where ``build_sigma`` puts it:
    diagonal tiles only)."""
    if nugget is None:
        return diag_tiles
    nb = diag_tiles.shape[-1]
    dtype = diag_tiles.dtype if dtype is None else dtype
    eye = torch.eye(nb, dtype=dtype, device=diag_tiles.device)
    return diag_tiles + torch.as_tensor(nugget, dtype=dtype) * eye


def diag_tiles(panels, params: MaternParams, nugget, gen: str, d_spatial: int):
    """The (T, nb, nb) diagonal tiles of the location blocks ``panels``,
    with the nugget applied (the GEN of the diagonal)."""
    diag = torch.stack(
        [build_sigma_panel(b, b, params, d_spatial=d_spatial, gen=gen) for b in panels]
    )
    return apply_nugget(diag, nugget, diag.dtype)


def generate_tiles(
    locs,
    params: MaternParams,
    tile_size: int = 0,
    nugget: float = 0.0,
    gen: str = "kernel",
    d_spatial: int = 2,
    *,
    device=None,
):
    """GEN phase: diagonal tiles and strict-lower column panels straight
    from the Matérn generator.

    Returns ``(diag, lower, nb, T)``: ``diag`` is (T, nb, nb) with the
    nugget applied and ``lower`` a generator yielding the (T-1-j, nb, nb)
    strict-lower tiles of column j in turn, so a consumer that drops each
    panel keeps one live.  Locations must be Morton-ordered by the caller.
    """
    locs = as_tensor(locs, device=device)
    n = locs.shape[0]
    p = params.p
    m = n * p
    nb = choose_tile_size(m, tile_size, multiple_of=p)
    nbl = nb // p  # locations per tile
    T = m // nb
    panels = [locs[t * nbl : (t + 1) * nbl] for t in range(T)]
    diag = diag_tiles(panels, params, nugget, gen, d_spatial)

    def lower_panels():
        for j in range(T - 1):
            rows = locs[(j + 1) * nbl :]
            blk = build_sigma_panel(
                rows, panels[j], params, d_spatial=d_spatial, gen=gen
            )
            yield blk.reshape(T - 1 - j, nb, nb)

    return diag, lower_panels(), nb, T


def compress_columns(
    locs,
    params: MaternParams,
    tile_size: int = 0,
    tol: float = 1e-7,
    max_rank: int = 0,
    nugget: float = 0.0,
    gen: str = "kernel",
    d_spatial: int = 2,
    scale=None,
    *,
    col_block: int = 1,
    dtype_policy=None,
    device=None,
    times: dict | None = None,
):
    """GEN + compress, one tile column at a time: the work every
    generator-direct compression runs, whatever storage it fills.

    Returns ``(diag, kmax, uv_dtype, columns)``: ``diag`` is (T, nb, nb)
    with the nugget applied, and ``columns`` yields ``(j, U, V, ranks)`` for
    each column j < T - 1, the truncated SVD (``svd_truncate_batch``) of
    its T-1-j strict-lower tiles only, cast to ``uv_dtype`` (the policy's
    narrow dtype, else the generated one) before the SVD.  ``col_block``
    columns share one SVD batch (it must divide T, as in the reference);
    each tile's SVD is its own, so the grouping changes no value.
    ``scale`` (the threshold reference) defaults to max(sigma2) + nugget,
    the dense path's max |diag(Sigma)|.
    """
    t0 = _lap(times, None, 0.0, params.sigma2)
    diag, lower, nb, T = generate_tiles(
        locs,
        params,
        tile_size=tile_size,
        nugget=nugget,
        gen=gen,
        d_spatial=d_spatial,
        device=device,
    )
    t0 = _lap(times, "gen", t0, diag)
    cb = max(int(col_block), 1)
    if T % cb:
        raise ValueError(f"col_block={cb} must divide n_tiles={T}")
    if max_rank <= 0:
        max_rank = max(8, nb // 4)
    kmax = min(max_rank, nb)
    if scale is None:
        scale = torch.max(params.sigma2) + nugget
    store = uv_dtype(dtype_policy, diag.dtype)

    def columns():
        t = t0
        group = []
        for j, tiles in enumerate(lower):
            group.append(tiles)
            if len(group) < cb and j < T - 2:
                continue
            t = _lap(times, "gen", t, tiles)
            batch = torch.cat(group) if len(group) > 1 else group[0]
            U, V, R = svd_truncate_batch(batch.to(store), tol, kmax, scale)
            t = _lap(times, "compress", t, U)
            lo = 0
            for c, g in enumerate(group):
                hi = lo + g.shape[0]
                yield j + 1 - len(group) + c, U[lo:hi], V[lo:hi], R[lo:hi]
                lo = hi
            group = []

    return diag, kmax, store, columns()


def tlr_compress_tiles(
    locs,
    params: MaternParams,
    tile_size: int = 0,
    tol: float = 1e-7,
    max_rank: int = 0,
    nugget: float = 0.0,
    gen: str = "kernel",
    d_spatial: int = 2,
    scale=None,
    dtype_policy=None,
    *,
    device=None,
    times: dict | None = None,
) -> TLRMatrix:
    """Generator-direct TLR compression (the production path, §5.3).

    Equivalent to ``tlr_compress(build_sigma(locs, params, "I", nugget))``
    to SVD tolerance, tile panel by tile panel, so the dense Sigma is never
    formed (``compress_columns``).  ``dtype_policy`` casts the off-diagonal
    panels to the policy's narrow dtype before their truncation SVD and
    stores U/V narrow; diagonal tiles keep the generated (wide) dtype.
    """
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
        dtype_policy=dtype_policy,
        device=device,
        times=times,
    )
    return fill_grid(diag, kmax, store, columns)


def fill_grid(diag, kmax: int, store: torch.dtype, columns) -> TLRMatrix:
    """The (T, T) grid TLRMatrix of ``compress_columns``' columns."""
    T, nb = diag.shape[0], diag.shape[1]
    kw = dict(dtype=store, device=diag.device)
    u = torch.zeros((T, T, nb, kmax), **kw)
    v = torch.zeros((T, T, nb, kmax), **kw)
    ranks = torch.zeros((T, T), dtype=torch.int32, device=diag.device)
    for j, U, V, R in columns:
        u[j + 1 :, j] = U
        v[j + 1 :, j] = V
        ranks[j + 1 :, j] = R
    return TLRMatrix(diag=diag, u=u, v=v, ranks=ranks)


def tlr_to_dense(t: TLRMatrix, symmetric: bool = True) -> torch.Tensor:
    T, nb = t.n_tiles, t.tile_size
    out = torch.zeros((T * nb, T * nb), dtype=t.diag.dtype, device=t.diag.device)
    for i in range(T):
        ri = slice(i * nb, (i + 1) * nb)
        out[ri, ri] = t.diag[i]
        for j in range(i):
            rj = slice(j * nb, (j + 1) * nb)
            block = (t.u[i, j] @ t.v[i, j].mT).to(out.dtype)
            out[ri, rj] = block
            if symmetric:
                out[rj, ri] = block.mT
    return out


# ---------------------------------------------------------------------------
# Recompression (the "GEMM + SVD" task of HiCMA)
# ---------------------------------------------------------------------------


def _bumped_rinv_t(r1, y):
    """y R_s^{-T}, R_s the square upper-triangular ``r1`` with every
    diagonal entry of magnitude at most 1e-40 + 1e-12 max|diag| raised by 1
    (those directions are the zero-padded rank columns, which the rank
    mask zeroes downstream)."""
    d = torch.diagonal(r1, dim1=-2, dim2=-1)
    lim = 1e-40 + 1e-12 * d.abs().amax(-1, keepdim=True)
    r_safe = r1 + torch.diag_embed((d.abs() <= lim).to(r1.dtype))
    return torch.linalg.solve_triangular(r_safe.mT, y, upper=False, left=False)


class _SafeQR(torch.autograd.Function):
    """Reduced QR with a derivative that survives the recompress concats'
    zero-padded rank columns (R exactly singular), as the reference's
    ``_safe_qr``: the forward is ``torch.linalg.qr``; the backward is the
    transpose of the reference's JVP, whose triangular solve against R
    takes R's (near-)zero diagonal entries raised by 1.  A wide R (2 kmax
    > nb) solves against its leading square block only."""

    @staticmethod
    def forward(ctx, a):
        q, r = torch.linalg.qr(a)
        ctx.save_for_backward(q, r)
        return q, r

    @staticmethod
    def backward(ctx, gq, gr):
        q, r = ctx.saved_tensors
        kk = r.shape[-2]
        qtgq = q.mT @ gq
        m = qtgq - gr @ r.mT
        low = torch.tril(m - m.mT, -1)
        if r.shape[-1] == kk:
            return _bumped_rinv_t(r, gq + q @ (low - m))
        ga = q @ gr
        ga[..., :kk] += _bumped_rinv_t(r[..., :kk], gq + q @ (low - qtgq))
        return ga


class _CoreSVD(torch.autograd.Function):
    """SVD of the square recompress core (``_svd_or_nan``) with a derivative
    that survives its repeated zero singular values, as the reference's
    ``_core_svd``: the backward is the transpose of the reference's JVP,
    whose 1 / (s_j^2 - s_i^2) terms are zero where the gap is at most
    1e-40 + 1e-12 max s^2."""

    @staticmethod
    def forward(ctx, core):
        u, s, vt = _svd_or_nan(core)
        ctx.save_for_backward(u, s, vt)
        return u, s, vt

    @staticmethod
    def backward(ctx, gu, gs, gvt):
        u, s, vt = ctx.saved_tensors
        s2 = s * s
        gap = s2[..., None, :] - s2[..., :, None]  # gap[i, j] = s_j^2 - s_i^2
        lim = 1e-40 + 1e-12 * s2.amax(-1, keepdim=True)[..., None]
        safe = gap.abs() > lim
        f = torch.where(safe, 1.0 / torch.where(safe, gap, 1.0), 0.0)
        au = f * (u.mT @ gu)
        bv = f * (vt @ gvt.mT)
        gp = torch.diag_embed(gs) + (au + au.mT) * s[..., None, :]
        gp = gp + s[..., :, None] * (bv + bv.mT)
        return u @ gp @ vt


def _recompress_parts(u1, v1, u2, v2, tol, scale):
    """(B..., nb, k) pairs -> recompressed sum with rank <= kmax, batched.

    QR(U')·QR(V') then SVD of the small core, both with the reference's
    guarded derivatives (``_SafeQR``, ``_CoreSVD``).  Returns (U, V, ranks,
    cs): ranks counts the singular values kept (int32) and cs is the raw
    spectrum (a NaN input tile surfaces there as non-finite values).  When
    2 kmax > nb, R is wide (nb, 2k) and the core is (nb, nb), as in the
    reference.
    """
    kmax = u1.shape[-1]
    qu, ru = _SafeQR.apply(torch.cat([u1, u2], dim=-1))
    qv, rv = _SafeQR.apply(torch.cat([v1, v2], dim=-1))
    core = ru @ rv.mT
    cu, cs, cvt = _CoreSVD.apply(core)
    mask = cs[..., :kmax] > _threshold(tol, scale, cs)
    s_m = torch.where(mask, cs[..., :kmax], 0.0)
    unew = (qu @ cu[..., :kmax]) * s_m[..., None, :]
    vnew = qv @ cvt[..., :kmax, :].mT
    vnew = torch.where(mask[..., None, :], vnew, 0.0)
    return unew, vnew, mask.sum(-1).to(torch.int32), cs


def _batched_recompress(u1, v1, u2, v2, tol, scale):
    """The 3-tuple form of ``_recompress_parts`` (no counting)."""
    return _recompress_parts(u1, v1, u2, v2, tol, scale)[:3]


def _batched_recompress_stat(u1, v1, u2, v2, tol, scale):
    """As ``_batched_recompress`` plus an int32 count of non-finite singular
    values (folded into ``FactorStatus.nonfinite_count``)."""
    un, vn, rn, cs = _recompress_parts(u1, v1, u2, v2, tol, scale)
    bad = torch.sum(~torch.isfinite(cs)).to(torch.int32)
    return un, vn, rn, bad


def recompress(u1, v1, u2, v2, tol: float, scale: float):
    """(u1 v1^T + u2 v2^T) -> (U, V, rank) with rank <= kmax (= u1 cols)."""
    return _batched_recompress(u1, v1, u2, v2, tol, scale)


# ---------------------------------------------------------------------------
# TLR Cholesky (right-looking; the paper's Fig. 1 dataflow on UV tiles)
# ---------------------------------------------------------------------------


class TLRCholesky(NamedTuple):
    diag: torch.Tensor  # (T, nb, nb) lower Cholesky factors of diagonal tiles
    u: torch.Tensor  # (T, T, nb, kmax) factor tiles  L[i,j] = u v^T
    v: torch.Tensor
    ranks: torch.Tensor
    status: FactorStatus | None = None  # breakdown accounting (if tracked)


def _put(x, index, value, fresh: bool):
    """x[index] = value, in place or, when ``fresh``, into a copy of x.

    The factorization and the solves pass ``fresh`` while autograd records
    their tensors (``ops.records_grad``): a tensor they would overwrite may
    be saved for the backward.  Without grad they write in place."""
    if fresh:
        x = x.clone()
    x[index] = value
    return x


def _sub(x, index, value, fresh: bool):
    """x[index] -= value, in place or, when ``fresh``, into a copy of x."""
    if fresh:
        x = x.clone()
    x[index] -= value
    return x


def index_of(sel: np.ndarray, device):
    """An index for the sorted positions ``sel``: a slice (a view, no copy)
    where they are consecutive, else an index tensor."""
    if len(sel) and sel[-1] - sel[0] == len(sel) - 1:
        return slice(int(sel[0]), int(sel[-1]) + 1)
    return torch.as_tensor(sel, device=device)


def _gemm_recompress(u, v, ranks, dst, uk, vk, li, lj, status, *, tol, scale, fresh):
    """The GEMM + recompress task on a batch of active pairs (in place
    unless ``fresh``):

        A[i, j] += -U_ik (V_ik^T V_jk) U_jk^T,  recompressed by QR + core SVD

    ``dst`` indexes the pairs' storage in ``u``, ``v``, ``ranks`` (a grid
    index ``(gi, gj)`` or a pair-slot index); ``li``, ``lj`` index their
    rows i and j in the panel column's live tiles ``uk``, ``vk``.  Returns
    ``(u, v, status)``, ``status`` with the non-finite singular values of
    these pairs added.
    """
    wij = vk[li].mT @ vk[lj]  # V_ik^T V_jk
    du = uk[li] @ wij  # U_ik W
    dv = -uk[lj]
    un, vn, rn, bad = sharded_recompress(
        u[dst], v[dst], du, dv, tol, scale, with_count=True
    )
    u = _put(u, dst, un, fresh)
    v = _put(v, dst, vn, fresh)
    ranks[dst] = rn
    return u, v, None if status is None else status.add_nonfinite(bad)


def _trsm_widened(lkk, vk):
    """The TRSM widening boundary: V cast up to L_kk's dtype, solved by the
    ``trsm`` kernel, cast back to its storage dtype (both casts are no-ops
    under one dtype)."""
    return ops.trsm(lkk, vk.to(lkk.dtype)).to(vk.dtype)


def _syrk_update(diag, live, uk, vk, fresh: bool):
    """D_i -= U_ik (V_ik^T V_ik) U_ik^T on the live diagonal tiles
    ``diag[live]`` by the ``tlr_mm`` kernel, in place (its ``out=`` form)
    or, when ``fresh``, into a copy of ``diag``; returns ``diag``.  With
    narrow U/V (a mixed policy) this is the SYRK widening boundary: the
    reference forms the product in the narrow dtype and subtracts it from
    the wide diagonal, and so does the kernel's narrow instance given the
    wide tiles as ``acc`` (the product widened exactly in its epilogue).
    """
    if fresh:
        return _put(diag, live, ops.tlr_mm(uk, vk, uk, vk, diag[live]), True)
    diag_live = diag[live]
    ops.tlr_mm(uk, vk, uk, vk, diag_live, out=diag_live)
    return diag


def tlr_panel_body(k: int, diag, u, v, ranks, status=None, *, tol, scale, pairs):
    """One right-looking panel step k, updating ``diag``/``u``/``v``/
    ``ranks`` in place, or into new tensors while autograd records them
    (``ops.records_grad``); the reference's ``pairs=(il, jl)`` form:

        POTRF — factor diagonal tile (k, k) (the ``potrf`` kernel)
        TRSM  — solve column k's V tiles of the rows i > k against it (the
                ``trsm`` kernel, L_kk broadcast over the rows)
        SYRK  — D_i -= U_ik (V_ik^T V_ik) U_ik^T for i > k (``tlr_mm``)
        GEMM  — A[i, j] += -U_ik (V_ik^T V_jk) U_jk^T for i > j > k, each
                recompressed by QR + core SVD

    The reference recompresses the whole static strict-lower pair list
    every step and masks the pairs with j <= k, which keep their U, V and
    rank.  Here only the active pairs (j > k) are gathered, recompressed and
    scattered back, so every value equals the reference's and about a third
    of the QR/SVD work is done.  One difference in accounting: a non-finite
    singular value is counted only while its pair is active.

    With U/V narrower than the diagonal tiles (a mixed policy), the TRSM
    and the SYRK widen as the reference's do (``_trsm_widened``,
    ``_syrk_update``); the GEMM and recompress run in the narrow dtype.

    A non-SPD tile gives a NaN POTRF factor, as ``jnp.linalg.cholesky``
    does.  Returns ``(diag, u, v, ranks)``, plus ``status`` when one is
    passed.
    """
    T = diag.shape[0]
    fresh = ops.records_grad(diag, u, v)
    il, jl = (np.asarray(x) for x in pairs)
    lkk = ops.potrf(diag[k : k + 1])
    if status is not None:
        status = status.update_potrf(lkk)
    live = slice(k + 1, T)
    if k + 1 < T:
        # ---- TRSM on the live rows of panel column k (V only; §5.3).
        vk = _trsm_widened(lkk, v[live, k])
        v = _put(v, (live, k), vk, fresh)
        uk = u[live, k].contiguous()
        # ---- SYRK onto the trailing diagonal tiles.
        diag = _syrk_update(diag, live, uk, vk, fresh)
        # ---- GEMM + recompress on the active pairs i > j > k.
        act = jl > k
        if act.any():
            ia, ja = il[act], jl[act]
            dev = u.device
            dst = (torch.as_tensor(ia, device=dev), torch.as_tensor(ja, device=dev))
            li = torch.as_tensor(ia - (k + 1), device=dev)
            lj = torch.as_tensor(ja - (k + 1), device=dev)
            u, v, status = _gemm_recompress(
                u,
                v,
                ranks,
                dst,
                uk,
                vk,
                li,
                lj,
                status,
                tol=tol,
                scale=scale,
                fresh=fresh,
            )
    diag = _put(diag, k, lkk[0], fresh)
    if status is not None:
        return diag, u, v, ranks, status
    return diag, u, v, ranks


def _shard_of(mesh, shard_axes):
    """The rank's ``PairShard`` when ``mesh`` and ``shard_axes`` place the
    pair slots on the mesh, else None (the whole layout is held)."""
    if mesh is None or not shard_axes:
        return None
    pair_axis(mesh)  # refuses what is not a named DeviceMesh
    return _pair_shard(mesh, tuple(shard_axes))


def _shard_column(k: int, lkk, up, vp, layout, shard, fresh: bool):
    """Panel column k on a mesh: the TRSM on this rank's slots of the
    column, then one ``all_gather`` of every rank's (U, solved V) slots.

    Returns ``(uk, vk, vp)``: the (T-1-k, nb, kmax) column of rows k+1..T-1
    on every rank, and ``vp`` with this rank's solved slots written.  Each
    rank sends its slots padded to the largest count of the step.
    """
    T, kmax = layout.n_tiles, up.shape[-1]
    rows, slots = column_owner_tables(layout)
    valid = rows[:, k, :] < T  # (S, L)
    counts = valid.sum(1)
    mine = int(counts[shard.index])
    own = index_of(slots[shard.index, k, :mine], up.device)
    vk_own = vp[own]
    if mine:
        vk_own = _trsm_widened(lkk, vk_own)
        vp = _put(vp, own, vk_own, fresh)
    pair = torch.cat([up[own], vk_own], dim=-1)
    parts = shard.gather_rows(pair, int(counts.max()))
    sd, sp = np.nonzero(valid)
    order = np.argsort(rows[sd, k, sp])
    at = (torch.as_tensor(x[order], device=parts.device) for x in (sd, sp))
    col = parts[tuple(at)]
    return col[..., :kmax].contiguous(), col[..., kmax:].contiguous(), vp


def tlr_panel_body_bc(
    k: int,
    diag,
    up,
    vp,
    ranks,
    status=None,
    *,
    layout,
    tol,
    scale,
    mesh=None,
    shard_axes=None,
):
    """One right-looking panel step k on pair-major strict-lower storage
    (``distribution.block_cyclic.PairLayout``), updating ``diag``, ``up``,
    ``vp``, ``ranks`` in place (into new tensors while autograd records
    them): the reference's ``tlr_panel_body_bc``.

    Panel column k is read through ``layout.pos[k+1:, k]``, the slots of
    its rows i > k only; the reference instead gathers all T rows through
    ``pos[:, k]`` with out-of-bounds sentinel slots for i <= k (filled with
    zeros, writes dropped), which torch indexing would refuse.  The GEMM +
    recompress runs on the active pairs (j > k) only, through the same
    helper as the grid body, with the same values and status accounting.
    With one shard the column's slots, and the active pairs', are
    consecutive, so both are views of the storage.

    ``mesh`` with ``shard_axes`` (the reference's placement arguments)
    select which slots this rank updates: ``up``, ``vp`` and ``ranks`` then
    hold only the rank's own ``layout.pairs_per_shard`` slots
    (``block_cyclic.PairShard``).  The rank solves its slots of column k,
    one ``all_gather`` gives every rank the whole column
    (``_shard_column``), every rank runs the same POTRF and diagonal SYRK
    on its replicated diagonal tiles, and each recompresses only its own
    active pairs; a status then counts only this rank's non-finite values
    (the caller sums them).  Without ``shard_axes`` every rank holds and
    updates the whole layout, as on one device.
    """
    T = diag.shape[0]
    dev = up.device
    fresh = ops.records_grad(diag, up, vp)
    shard = _shard_of(mesh, shard_axes)
    if shard is not None and fresh:
        raise ValueError(
            "the mesh forms define no derivative through their collectives"
        )
    lkk = ops.potrf(diag[k : k + 1])
    if status is not None:
        status = status.update_potrf(lkk)
    if k + 1 < T:
        if shard is None:
            col = index_of(layout.pos[k + 1 :, k], dev)
            # ---- TRSM on panel column k (V only; U untouched, §5.3).
            vk = _trsm_widened(lkk, vp[col])
            vp = _put(vp, col, vk, fresh)
            uk = up[col]
            il, jl = layout.il, layout.jl
        else:
            uk, vk, vp = _shard_column(k, lkk, up, vp, layout, shard, fresh)
            il, jl = (t[shard.index] for t in owned_pair_tables(layout))
        # ---- SYRK onto the trailing diagonal tiles i > k.
        diag = _syrk_update(diag, slice(k + 1, T), uk, vk, fresh)
        # ---- GEMM + recompress over the active pairs (pads fail il > jl).
        act = np.nonzero((il > jl) & (jl > k))[0]
        if len(act):
            li = torch.as_tensor(il[act] - (k + 1), device=dev)
            lj = torch.as_tensor(jl[act] - (k + 1), device=dev)
            up, vp, status = _gemm_recompress(
                up,
                vp,
                ranks,
                index_of(act, dev),
                uk,
                vk,
                li,
                lj,
                status,
                tol=tol,
                scale=scale,
                fresh=fresh,
            )
    diag = _put(diag, k, lkk[0], fresh)
    if status is not None:
        return diag, up, vp, ranks, status
    return diag, up, vp, ranks


def _loop(body, diag, u, v, ranks, k_lo: int, k_hi: int, status, **kw):
    """``body`` for k in [k_lo, k_hi), in place unless autograd records the
    tensors; a ``status`` passed rides along and the result is then a
    5-tuple."""
    for k in range(k_lo, k_hi):
        out = body(k, diag, u, v, ranks, status, **kw)
        diag, u, v, ranks = out[:4]
        if status is not None:
            status = out[4]
    if status is not None:
        return diag, u, v, ranks, status
    return diag, u, v, ranks


def panel_loop(diag, u, v, ranks, k_hi: int, *, tol, scale, status=None, k_lo=0):
    """The grid body for k in [k_lo, k_hi) over the strict-lower pair list
    (the reference's ``pairs=(il, jl)`` form), in place."""
    pairs = np.tril_indices(diag.shape[0], k=-1)
    kw = dict(tol=tol, scale=scale, pairs=pairs)
    return _loop(tlr_panel_body, diag, u, v, ranks, k_lo, k_hi, status, **kw)


def pair_panel_loop(
    diag,
    up,
    vp,
    ranks,
    k_hi: int,
    *,
    layout,
    tol,
    scale,
    status=None,
    k_lo=0,
    mesh=None,
    shard_axes=None,
):
    """The pair body for k in [k_lo, k_hi), in place; ``mesh`` and
    ``shard_axes`` as for ``tlr_panel_body_bc``."""
    kw = dict(layout=layout, tol=tol, scale=scale, mesh=mesh, shard_axes=shard_axes)
    return _loop(tlr_panel_body_bc, diag, up, vp, ranks, k_lo, k_hi, status, **kw)


def super_steps(n_tiles: int, super_panels: int) -> list[tuple[int, int]]:
    """The panel steps [k_lo, k_hi) of each of ``super_panels`` super-steps
    of a T-tile factorization (the last tile needs only its POTRF, so the
    last range ends at T - 1).  T must be a multiple of ``super_panels``,
    as the reference asserts."""
    if super_panels < 1 or n_tiles % super_panels:
        raise ValueError(f"super_panels={super_panels} must divide n_tiles={n_tiles}")
    chunk = n_tiles // super_panels
    return [
        (s * chunk, min((s + 1) * chunk, n_tiles - 1)) for s in range(super_panels)
    ]


def factorize(
    loop,
    diag,
    u,
    v,
    ranks,
    *,
    super_panels=1,
    track_status=False,
    times=None,
    in_place=False,
):
    """A right-looking TLR factorization driven by ``loop`` (``panel_loop``
    or ``pair_panel_loop`` with its keywords bound), returning
    ``(diag_L, u, v, ranks)``, plus the merged ``FactorStatus`` with
    ``track_status``.

    The inputs are cloned once (not with ``in_place``: the factor is then
    written into the inputs' own storage); the panel steps then update the
    copy in place (while autograd records the tensors, each step builds new
    ones instead), in ``super_panels`` super-steps (``super_steps``), each with its
    own status accumulation, merged as the reference merges its slices'.
    The last tile needs only its POTRF (the ``potrf`` kernel).
    """
    T = diag.shape[0]
    if not in_place:
        diag, u, v, ranks = (x.clone() for x in (diag, u, v, ranks))
    elif ops.records_grad(diag, u, v):
        raise ValueError("in_place=True factors without autograd")
    t0 = _lap(times, None, 0.0, diag)
    status = None
    for k_lo, k_hi in super_steps(T, super_panels):
        part = init_status(diag.dtype, diag.device) if track_status else None
        out = loop(diag, u, v, ranks, k_hi, k_lo=k_lo, status=part)
        diag, u, v, ranks = out[:4]
        if track_status:
            status = out[4] if status is None else status.merge(out[4])
    lkk = ops.potrf(diag[T - 1 :])
    diag = _put(diag, T - 1, lkk[0], ops.records_grad(diag, u, v))
    _lap(times, "factorize", t0, diag)
    if track_status:
        return diag, u, v, ranks, status.update_potrf(lkk)
    return diag, u, v, ranks


def tlr_cholesky(
    t: TLRMatrix,
    tol: float = 1e-9,
    scale=1.0,
    track_status: bool = False,
    times: dict | None = None,
) -> TLRCholesky:
    """Factor A = L L^T keeping off-diagonal tiles compressed (the grid
    body over the strict-lower pair list, ``factorize``)."""
    loop = functools.partial(panel_loop, tol=tol, scale=scale)
    out = factorize(
        loop, t.diag, t.u, t.v, t.ranks, track_status=track_status, times=times
    )
    return TLRCholesky(*out)


def solve_lower_grid(diag_l, u, v, z) -> torch.Tensor:
    """Forward substitution L alpha = z on grid-form TLR factors; each
    diagonal tile's solve is the ``trsm`` kernel.  In place on a copy of z,
    or into new tensors while autograd records the inputs."""
    T, nb = diag_l.shape[0], diag_l.shape[1]
    fresh = ops.records_grad(diag_l, u, v, z)
    z = z.reshape(T, nb).clone()
    out = torch.empty_like(z)
    for k in range(T):
        a = ops.trsm(diag_l[k : k + 1], z[k][None, :, None])[0, :, 0]
        out = _put(out, k, a, fresh)
        if k + 1 < T:
            # z_i -= U_ik (V_ik^T a_k) for i > k (narrow U/V widened, as
            # the reference's einsum promotes them)
            vk, uk = v[k + 1 :, k].to(z.dtype), u[k + 1 :, k].to(z.dtype)
            wk = torch.einsum("tnk,n->tk", vk, a)
            z = _sub(z, slice(k + 1, T), torch.einsum("tnk,tk->tn", uk, wk), fresh)
    return out.reshape(-1)


def tlr_solve_lower(chol: TLRCholesky, z) -> torch.Tensor:
    """Solve L alpha = z with L in TLR form (forward substitution)."""
    z = as_tensor(z, device=chol.diag.device, dtype=chol.diag.dtype)
    return solve_lower_grid(chol.diag, chol.u, chol.v, z)


def tlr_logdet(chol: TLRCholesky) -> torch.Tensor:
    diags = torch.diagonal(chol.diag, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diags))


def tlr_matvec(t: TLRMatrix, x) -> torch.Tensor:
    """y = A x with A symmetric in TLR form."""
    T, nb = t.n_tiles, t.tile_size
    x = as_tensor(x, device=t.diag.device, dtype=t.diag.dtype).reshape(T, nb)
    y = torch.einsum("tnm,tm->tn", t.diag, x)
    for k in range(T - 1):
        uk, vk = t.u[k + 1 :, k], t.v[k + 1 :, k]
        # strict-lower tiles of column k: y_i += U_ik (V_ik^T x_k)
        w = torch.einsum("tnk,n->tk", vk, x[k])
        y[k + 1 :] += torch.einsum("tnk,tk->tn", uk, w)
        # their transposes (row k): y_k += sum_{i>k} V_ik (U_ik^T x_i)
        wu = torch.einsum("tnk,tn->tk", uk, x[k + 1 :])
        y[k] += torch.einsum("tnk,tk->n", vk, wu)
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# Log-likelihood through the TLR factorization (Eq. 1)
# ---------------------------------------------------------------------------


def _loglik_of(diag_l, alpha, m: int, status: FactorStatus | None = None):
    """Eq. 1 from the factored diagonal tiles and the forward solve.

    With a ``FactorStatus``, a broken factorization yields the finite
    sentinel loglik (``recovery.sentinel_loglik``) instead of NaN."""
    quad = torch.sum(alpha * alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(diag_l, dim1=-2, dim2=-1)))
    ll = -0.5 * (m * math.log(2.0 * math.pi) + logdet + quad)
    if status is not None:
        status = status.add_nonfinite((~torch.isfinite(ll)).to(torch.int32))
        ok = status.ok
        ll = torch.where(ok, ll, sentinel_loglik(ll.dtype))
        logdet = torch.where(ok, logdet, 0.0)
        quad = torch.where(ok, quad, 0.0)
    return LoglikResult(ll, logdet, quad, None, status)


def tlr_loglik_from_matrix(
    t: TLRMatrix,
    z,
    tol: float = 1e-9,
    scale=1.0,
    track_status: bool = True,
    times: dict | None = None,
) -> LoglikResult:
    chol = tlr_cholesky(t, tol=tol, scale=scale, track_status=track_status, times=times)
    t0 = _lap(times, None, 0.0, chol.diag)
    alpha = tlr_solve_lower(chol, z)
    res = _loglik_of(chol.diag, alpha, t.shape[0], status=chol.status)
    _lap(times, "solve", t0, res.loglik)
    return res


def tlr_loglik(
    dists,
    z,
    params: MaternParams,
    tol: float = 1e-7,
    max_rank: int = 64,
    tile_size: int = 0,
    nugget: float = 0.0,
    *,
    locs=None,
    from_tiles: bool = False,
    gen: str = "kernel",
    track_status: bool = True,
    dtype_policy=None,
    device=None,
    times: dict | None = None,
) -> LoglikResult:
    """End-to-end TLR likelihood: GEN -> compress -> TLR Cholesky -> solve.

    Locations must be Morton-ordered by the caller.  With
    ``from_tiles=True`` (the generator-direct production path) tiles come
    from ``tlr_compress_tiles(locs, ...)``, ``dists`` may be None and the
    dense Sigma is never formed.  ``gen`` is ``"kernel"`` (the reference's
    ``"pallas"``) or ``"plain"`` (its ``"xla"``).  Otherwise the dense Sigma
    is built from ``dists`` and compressed (validation / small n).
    ``dtype_policy`` stores U/V narrow (see the module docstring).  Numpy
    inputs go to ``device``.
    """
    if from_tiles:
        if locs is None:
            raise ValueError("from_tiles=True requires locs (Morton-ordered)")
        scale = torch.max(params.sigma2) + nugget
        t = tlr_compress_tiles(
            locs,
            params,
            tile_size=tile_size,
            tol=tol,
            max_rank=max_rank,
            nugget=nugget,
            gen=gen,
            scale=scale,
            dtype_policy=dtype_policy,
            device=device,
            times=times,
        )
    else:
        sigma = build_sigma(
            None, params, representation="I", nugget=nugget, dists=dists, device=device
        )
        scale = torch.max(torch.abs(torch.diagonal(sigma)))
        t = tlr_compress(
            sigma,
            tile_size=tile_size,
            tol=tol,
            max_rank=max_rank,
            scale=scale,
            multiple_of=params.p,
            dtype_policy=dtype_policy,
        )
        del sigma
    z = as_tensor(z, device=t.diag.device, dtype=t.diag.dtype)
    return tlr_loglik_from_matrix(
        t, z, tol=tol, scale=scale, track_status=track_status, times=times
    )


# ---------------------------------------------------------------------------
# Reports: memory footprint (Fig. 6) and rank distribution (Fig. 5)
# ---------------------------------------------------------------------------


def memory_footprint(t: TLRMatrix, itemsize: int | None = None) -> dict:
    """Bytes for the TLR representation (actual ranks) vs dense."""
    T, nb = t.n_tiles, t.tile_size
    if itemsize is None:
        itemsize = t.diag.element_size()
    ranks = t.ranks.cpu().numpy()
    il, jl = np.tril_indices(T, k=-1)
    lowrank_entries = int(2 * nb * ranks[il, jl].sum())
    diag_entries = T * nb * nb
    m = T * nb
    tlr_bytes = (lowrank_entries + diag_entries) * itemsize
    dense_bytes = m * m * itemsize
    return dict(
        tlr_bytes=tlr_bytes,
        dense_bytes=dense_bytes,
        ratio=dense_bytes / max(tlr_bytes, 1),
        diag_bytes=diag_entries * itemsize,
        lowrank_bytes=lowrank_entries * itemsize,
    )


def rank_distribution(t: TLRMatrix) -> np.ndarray:
    """(T, T) array: off-diagonal actual ranks, diagonal = nb (dense)."""
    ranks = t.ranks.cpu().numpy().copy()
    ranks = ranks + ranks.T
    np.fill_diagonal(ranks, t.tile_size)
    return ranks


def tlr_mm_flops(nb: int, k: int) -> int:
    """The paper's §5.3 model: one TLR-MM costs 36 nb k^2 flops."""
    return 36 * nb * k * k

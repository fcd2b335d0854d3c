"""Cokriging as a service: factor once, predict many (Eq. 3 at scale).

Counterpart of ``repro.serving.cokrige_service``:

  * ``fit_factor`` (once per locations and theta): generator-direct GEN +
    compress into pair-major storage, the pair-native TLR Cholesky, and
    both triangular sweeps for ``alpha = Sigma^{-1} z``; returns a
    ``CokrigeFactor`` that stays on the device.
  * ``predict_batch`` (per request): one c0 panel batch generated against
    the observations, one multi-right-hand-side forward sweep over the
    cached factor, and small contractions.  Sigma is never rebuilt and the
    factor never recomputed.

The products of a batch are the cokriging mean, kriging variances, central
prediction intervals and, given a ``torch.Generator``, conditional draws
(per location, from the p x p conditional covariance).

On a mesh (``mesh=`` a ``DeviceMesh``, ``launch.mesh``; every rank makes
the same call) ``fit_factor`` compresses and factors with the rank's share
of the pair slots (``core.dist_tlr``; ``row_axes``, ``shard_svd`` and
``shard_recompress`` as there), and the factor holds the rank's own slots
(``n_shards`` the mesh's pair-axis size) beside whole diagonal tiles and a
whole alpha.  A request splits the c0 tile rows over the row axes, as the
reference's ``P(row, None, None)``: each row block is generated once, by
the rank at "model" coordinate 0, and one ``all_reduce`` gives every rank
the whole panel; the forward sweep runs on the rank's own slots, and the
prediction comes back whole on every rank.  Every host-side decision (the
health check, the jitter ladder of degraded mode) reads the status, which
is whole on every rank, so all ranks take it the same way.

PyTorch runs eagerly, so ``make_cokrige_serve_fns`` returns the two
functions bound to one configuration, with nothing compiled.  The two
serving phases as dry-run lowerables (``launch.dryrun``, ``lowerables``) are
``cokrige_fit_lowerable`` and ``cokrige_predict_lowerable``: the bodies
without the request validation and the recovery ladder, as the
reference's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.covariance import (
    GENERATORS,
    MaternParams,
    build_c0_panels,
    build_sigma_panel,
    cross_cov_at_zero,
)
from ..core.dist_tlr import (
    dist_compress_tiles,
    dist_tlr_cholesky_pairs,
    dist_tlr_solve_lower_pairs,
    dist_tlr_solve_upper_pairs,
)
from ..core.prediction import CokrigeFactor
from ..core.tlr import _lap, choose_tile_size
from ..device import as_tensor
from ..distribution.block_cyclic import pair_layout, pair_shard, pair_shards
from ..launch.mesh import all_reduce_, mesh_grid

__all__ = [
    "CokrigeServeConfig",
    "CokrigePrediction",
    "ServeError",
    "fit_factor",
    "heal_factor",
    "predict_batch",
    "predict_with_factor",
    "make_cokrige_serve_fns",
]


class ServeError(ValueError):
    """Structured refusal: the service will not serve garbage.

    ``code`` is machine-readable (``bad_shape`` | ``bad_dtype`` |
    ``nonfinite_locs`` | ``broken_factor``); ``status`` carries the
    factor's ``FactorStatus.as_dict()`` when the refusal is about factor
    health.  ``to_dict()`` is the wire form.
    """

    def __init__(
        self,
        code: str,
        message: str,
        status: dict | None = None,
        detail: dict | None = None,
    ):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message
        self.status = status
        self.detail = detail or {}

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "message": self.message,
            "status": self.status,
            "detail": self.detail,
        }


@dataclasses.dataclass(frozen=True)
class CokrigeServeConfig:
    """Static knobs of one serving deployment.

    tile_size/max_rank/tol as for the TLR path (0 picks the heuristic);
    ``gen`` is ``"kernel"`` or ``"plain"`` (the reference's ``"pallas"`` and
    ``"xla"``); ``interval`` is the central prediction-interval mass (0.95:
    the 2.5%/97.5% band).  ``col_block`` (columns to one compression SVD
    batch) and ``super_panels`` (super-steps of the factorization) are
    passed on as in the reference, and so are its sharding knobs
    (``row_axes``, ``shard_svd``, ``shard_recompress``), which select
    nothing without a mesh.  ``row_axes`` may not name "model", which always
    closes the pair axis.
    """

    tile_size: int = 0
    max_rank: int = 0
    tol: float = 1e-7
    nugget: float = 0.0
    gen: str = "plain"
    d_spatial: int = 2
    row_axes: tuple = ("data",)
    col_block: int = 1
    shard_svd: bool = True
    shard_recompress: bool = True
    super_panels: int = 1
    interval: float = 0.95
    # Request validation in ``predict_batch``: refuse malformed or
    # non-finite prediction locations and broken factors with a structured
    # ``ServeError`` instead of serving NaNs.
    validate: bool = True
    # Degraded mode: a broken factor is re-fit with the nugget escalated
    # along the jitter ladder (``heal_factor``) instead of refused.
    degraded: bool = False
    degraded_initial_jitter: float = 1e-8
    degraded_factor: float = 10.0
    degraded_max_jitter: float = 1e-2
    degraded_max_attempts: int = 5

    def __post_init__(self):
        if self.gen not in GENERATORS:
            raise ValueError(f"gen must be one of {GENERATORS}, got {self.gen!r}")
        if "model" in tuple(self.row_axes):
            raise ValueError(
                f"row_axes={self.row_axes!r}: 'model' always closes the pair axis"
            )


class CokrigePrediction(NamedTuple):
    """One decoded batch: mean, kriging variance, interval, draws."""

    mean: torch.Tensor  # (B, p) cokriging predictions (Eq. 3)
    variance: torch.Tensor  # (B, p) kriging variances, clipped >= 0
    lower: torch.Tensor  # (B, p) central-interval bounds
    upper: torch.Tensor  # (B, p)
    draws: torch.Tensor | None = None  # (n_draws, B, p) conditional draws


def _z_crit(interval: float, like: torch.Tensor) -> torch.Tensor:
    """Two-sided normal critical value for the central interval mass."""
    q = torch.as_tensor(0.5 + 0.5 * interval, dtype=like.dtype, device=like.device)
    return torch.special.ndtri(q)


def fit_factor(
    locs,
    z,
    params: MaternParams,
    cfg: CokrigeServeConfig,
    mesh=None,
    nugget=None,
    *,
    device=None,
    times: dict | None = None,
) -> CokrigeFactor:
    """Prefill: compress and factor Sigma once, precompute alpha.

    Generator-direct: the dense (m, m) Sigma never exists.  Locations must
    be Morton-ordered by the caller.  The factorization's ``FactorStatus``
    rides on ``factor.status`` without a synchronisation; ``predict_batch``
    checks it before serving.  ``nugget`` is added to ``cfg.nugget`` (the
    jitter ladder of ``heal_factor``).  Numpy inputs go to ``device`` (the
    CUDA device unless ``"cpu"`` is asked for).  Given a ``times`` dict,
    the seconds of each phase (``gen``, ``compress``, ``factorize``,
    ``solve``) are added to it.  On a mesh the factor holds the rank's own
    pair slots (see the module docstring).
    """
    locs = as_tensor(locs, device=device)
    z = as_tensor(z, device=locs.device)
    m = z.shape[0]
    p = params.p
    nb = choose_tile_size(m, cfg.tile_size, multiple_of=p)
    layout = pair_layout(m // nb, pair_shards(mesh, cfg.row_axes))
    eff_nugget = cfg.nugget if nugget is None else cfg.nugget + nugget
    scale = torch.max(params.sigma2) + cfg.nugget
    shards = dict(mesh=mesh, row_axes=cfg.row_axes)
    t = dist_compress_tiles(
        locs,
        params,
        tile_size=cfg.tile_size,
        tol=cfg.tol,
        max_rank=cfg.max_rank,
        nugget=eff_nugget,
        gen=cfg.gen,
        d_spatial=cfg.d_spatial,
        scale=scale,
        layout=layout,
        col_block=cfg.col_block,
        shard_svd=cfg.shard_svd,
        times=times,
        **shards,
    )
    diag_l, u, v, ranks, status = dist_tlr_cholesky_pairs(
        t.diag,
        t.u,
        t.v,
        t.ranks,
        layout=layout,
        tol=cfg.tol,
        scale=scale,
        super_panels=cfg.super_panels,
        shard_recompress=cfg.shard_recompress,
        own_slots=t.shard is not None,
        track_status=True,
        times=times,
        **shards,
    )
    del t
    # with shard_recompress the factor holds the rank's own slots
    shard = pair_shard(mesh, cfg.row_axes) if cfg.shard_recompress else None
    shards["own_slots"] = shard is not None
    t0 = _lap(times, None, 0.0, diag_l)
    zt = z.to(diag_l.dtype)
    y = dist_tlr_solve_lower_pairs(diag_l, u, v, zt, layout=layout, **shards)
    alpha = dist_tlr_solve_upper_pairs(diag_l, u, v, y, layout=layout, **shards)
    status = status.add_nonfinite(torch.sum(~torch.isfinite(alpha)).to(torch.int32))
    _lap(times, "solve", t0, alpha)
    return CokrigeFactor(
        diag_l=diag_l,
        u=u,
        v=v,
        ranks=ranks,
        alpha=alpha,
        locs=locs,
        params=params,
        kind="tlr",
        n_shards=layout.n_shards,
        d_spatial=cfg.d_spatial,
        z=z,
        status=status,
        shard=None if shard is None else shard.index,
    )


def _c0_row_block(T: int, mesh, row_axes) -> tuple[int, int]:
    """The tile rows [lo, hi) of c0 this rank generates: the tile rows split
    into contiguous blocks over the row axes (``P(row, None, None)``), each
    generated by the rank at "model" coordinate 0 of its row coordinate; an
    empty range on the others."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh_grid(mesh).shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    rows = [a for a in row_axes if a in names]
    if any(coord[a] for a in names if a not in rows):
        return 0, 0
    block, count = 0, 1
    for a in rows:
        block, count = block * int(sizes[a]) + coord[a], count * int(sizes[a])
    bounds = np.linspace(0, T, count + 1).round().astype(int)
    return int(bounds[block]), int(bounds[block + 1])


def _predict_core(
    factor: CokrigeFactor, pred_locs: torch.Tensor, *, gen: str, mesh=None,
    row_axes=("data",),
):
    """Mean and conditional covariance of one batch against a cached factor.

    Returns (mean (B, p), cond_cov (B, p, p)).  The c0 panel batch is
    consumed twice: the mean is its contraction with the precomputed alpha;
    the conditional covariance is C(0) - w^T w with w = L^{-1} c0 from one
    multi-right-hand-side forward sweep: per-location (p, p) blocks, never
    the O(B^2) joint.
    """
    params = factor.params
    p = params.p
    B = pred_locs.shape[0]
    m = factor.m
    if factor.kind == "dense":
        c0 = build_sigma_panel(
            factor.locs, pred_locs, params, d_spatial=factor.d_spatial, gen=gen
        )  # (m, B*p)
        w = torch.linalg.solve_triangular(factor.diag_l, c0, upper=False)
    else:
        T, nb = factor.diag_l.shape[0], factor.diag_l.shape[1]
        layout = pair_layout(T, factor.n_shards)
        nbl = nb // p
        kw = dict(nbl=nbl, d_spatial=factor.d_spatial, gen=gen)
        if mesh is None:
            c0 = build_c0_panels(factor.locs, pred_locs, params, **kw)
        else:
            group = pair_shard(mesh, row_axes).group
            lo, hi = _c0_row_block(T, mesh, row_axes)
            c0 = pred_locs.new_zeros((T, nb, B * p))
            if hi > lo:
                obs = factor.locs[lo * nbl : hi * nbl]
                c0[lo:hi] = build_c0_panels(obs, pred_locs, params, **kw)
            all_reduce_(c0, group=group)
        c0 = c0.reshape(m, B * p)
        w = dist_tlr_solve_lower_pairs(
            factor.diag_l, factor.u, factor.v, c0, layout=layout, mesh=mesh,
            row_axes=row_axes, own_slots=factor.shard is not None,
        )
    mean = (c0.T @ factor.alpha).reshape(B, p)
    w3 = w.reshape(m, B, p)
    c00 = cross_cov_at_zero(params, d_spatial=factor.d_spatial)
    cond = c00[None] - torch.einsum("mbp,mbq->bpq", w3, w3)
    return mean, cond


def predict_with_factor(
    factor: CokrigeFactor,
    pred_locs,
    *,
    interval: float = 0.95,
    gen: str = "plain",
    mesh=None,
    row_axes=("data",),
    generator: torch.Generator | None = None,
    n_draws: int = 1,
) -> CokrigePrediction:
    """Decode one batch: mean, variance, interval, optional draws.

    A pure function of the factor (on a mesh, of every rank's share of
    it).  ``generator`` (a ``torch.Generator`` on
    the factor's device; the reference takes a JAX key) switches on
    conditional-simulation draws: (n_draws, B, p) samples from each
    location's conditional law N(mean, cond_cov), through the Cholesky of
    the jittered (p, p) conditional covariance.
    """
    alpha = factor.alpha
    pred_locs = as_tensor(pred_locs, device=alpha.device, dtype=alpha.dtype)
    mean, cond = _predict_core(factor, pred_locs, gen=gen, mesh=mesh, row_axes=row_axes)
    var = torch.clamp(torch.diagonal(cond, dim1=-2, dim2=-1), min=0.0)
    half = _z_crit(interval, var) * torch.sqrt(var)
    draws = None
    if generator is not None:
        p = mean.shape[-1]
        tr = torch.diagonal(cond, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(p, dtype=cond.dtype, device=cond.device)
        lc = torch.linalg.cholesky(cond + 1e-10 * tr[:, None, None] * eye)
        eps = torch.randn(
            (n_draws,) + tuple(mean.shape),
            generator=generator,
            dtype=mean.dtype,
            device=mean.device,
        )
        draws = mean[None] + torch.einsum("bpq,nbq->nbp", lc, eps)
    return CokrigePrediction(
        mean=mean, variance=var, lower=mean - half, upper=mean + half, draws=draws
    )


def make_cokrige_serve_fns(cfg: CokrigeServeConfig, mesh=None):
    """``(fit_factor(locs, z, params, nugget=None, device=None),
    predict(factor, pred_locs, generator=None, n_draws=1))`` for one
    deployment config.

    The reference returns the pair jit-compiled; PyTorch runs eagerly, so
    these are the plain functions with the configuration and the mesh bound.
    """
    pair_shards(mesh, cfg.row_axes)
    fit = functools.partial(fit_factor, cfg=cfg, mesh=mesh)

    def predict(factor, pred_locs, generator=None, n_draws: int = 1):
        return predict_with_factor(
            factor,
            pred_locs,
            interval=cfg.interval,
            gen=cfg.gen,
            mesh=mesh,
            row_axes=cfg.row_axes,
            generator=generator,
            n_draws=n_draws,
        )

    return fit, predict


def _factor_ok(factor: CokrigeFactor) -> bool:
    """Host-side health check (None status: an untracked factor)."""
    return factor.status is None or bool(factor.status.ok)


def _validate_request(factor: CokrigeFactor, pred_locs):
    """Refuse malformed requests up front, on the host."""
    if isinstance(pred_locs, torch.Tensor):
        pred_locs = pred_locs.detach().cpu().numpy()
    pl = np.asarray(pred_locs)
    if pl.ndim != 2 or pl.shape[-1] != factor.d_spatial:
        raise ServeError(
            "bad_shape",
            f"pred_locs must have shape (B, {factor.d_spatial}), got {pl.shape}",
        )
    if not np.issubdtype(pl.dtype, np.floating):
        raise ServeError(
            "bad_dtype", f"pred_locs must be a floating dtype, got {pl.dtype}"
        )
    if not np.all(np.isfinite(pl)):
        bad = np.argwhere(~np.isfinite(pl))
        raise ServeError(
            "nonfinite_locs",
            f"{len(bad)} non-finite coordinate(s) in pred_locs "
            f"(first at row {int(bad[0][0])})",
            detail={"n_nonfinite": int(len(bad)), "first_row": int(bad[0][0])},
        )


def heal_factor(
    factor: CokrigeFactor, cfg: CokrigeServeConfig, mesh=None
) -> CokrigeFactor:
    """Re-fit a broken factor with the nugget escalated along the ladder.

    Returns the first healthy re-fit (or ``factor`` itself if it is
    healthy).  Raises ``ServeError(code="broken_factor")`` when the ladder
    is exhausted or the factor carries no data to re-fit from.
    """
    if _factor_ok(factor):
        return factor
    status = factor.status.as_dict() if factor.status is not None else None
    if factor.z is None:
        raise ServeError(
            "broken_factor",
            "factor failed health check and carries no z to re-fit from",
            status=status,
        )
    jitter = cfg.degraded_initial_jitter
    tried = []
    cand = factor
    for _ in range(cfg.degraded_max_attempts):
        tried.append(jitter)
        cand = fit_factor(
            factor.locs, factor.z, factor.params, cfg, mesh, nugget=jitter
        )
        if _factor_ok(cand):
            return cand
        jitter = min(jitter * cfg.degraded_factor, cfg.degraded_max_jitter)
    last = cand.status.as_dict() if cand.status is not None else None
    raise ServeError(
        "broken_factor",
        f"jitter ladder exhausted after {len(tried)} re-fit(s) "
        f"(jitters tried: {tried})",
        status=last,
        detail={"jitters_tried": tried},
    )


def predict_batch(
    factor: CokrigeFactor,
    pred_locs,
    cfg: CokrigeServeConfig = CokrigeServeConfig(),
    mesh=None,
    generator: torch.Generator | None = None,
    n_draws: int = 1,
) -> CokrigePrediction:
    """The decode entry point of a deployment.

    With ``cfg.validate`` (the default) the request is checked first:
    malformed or non-finite ``pred_locs``, or a factor whose
    ``FactorStatus`` failed, raise a structured ``ServeError`` instead of
    serving NaNs.  ``cfg.degraded`` instead re-fits a broken factor through
    ``heal_factor`` (the healed handle serves this request; a caller that
    wants to keep it calls ``heal_factor`` itself).
    """
    if cfg.validate:
        _validate_request(factor, pred_locs)
        if not _factor_ok(factor):
            if cfg.degraded:
                factor = heal_factor(factor, cfg, mesh)
            else:
                raise ServeError(
                    "broken_factor",
                    "factor failed its factorization health check; re-fit "
                    "with a larger nugget (heal_factor) or enable degraded "
                    "mode",
                    status=factor.status.as_dict(),
                )
    _, predict = make_cokrige_serve_fns(cfg, mesh)
    return predict(factor, pred_locs, generator=generator, n_draws=n_draws)


# ---------------------------------------------------------------------------
# Dry-run lowerables: the two serving phases as (fn, specs)
# ---------------------------------------------------------------------------


def cokrige_fit_lowerable(
    n: int,
    p: int,
    params,
    *,
    tile_size: int,
    max_rank: int,
    tol: float,
    nugget: float = 0.0,
    gen: str = "kernel",
    mesh,
    dtype=torch.float32,
    row_axes=("data",),
):
    """(fn, specs) of the prefill phase: ``fn(locs, z)`` (both replicated)
    gives the factor's raw ``(diag_l, u, v, ranks, alpha)``, on a mesh u/v/
    ranks the rank's own pair slots, so they chain into
    ``cokrige_predict_lowerable``'s inputs.  The status rides along unread
    (no host check: the recovery ladder is not part of the body)."""
    from ..lowerables import Spec

    cfg = CokrigeServeConfig(
        tile_size=tile_size, max_rank=max_rank, tol=tol, nugget=nugget, gen=gen,
        row_axes=tuple(row_axes),
    )

    def fn(locs, z):
        with torch.no_grad():
            f = fit_factor(locs, z, params, cfg, mesh=mesh)
        return f.diag_l, f.u, f.v, f.ranks, f.alpha

    return fn, (Spec((n, 2), dtype), Spec((n * p,), dtype))


def cokrige_predict_lowerable(
    n: int,
    p: int,
    params,
    *,
    tile_size: int,
    max_rank: int,
    batch: int = 512,
    gen: str = "kernel",
    mesh,
    dtype=torch.float32,
    row_axes=("data",),
    interval: float = 0.95,
):
    """(fn, specs) of the decode phase: ``fn(diag_l, u, v, ranks, alpha,
    locs, pred_locs)`` gives (mean, variance, lower, upper) of ``batch``
    points.  The factor arrives as inputs, not updated (reuse across
    requests is the serving contract): u/v/ranks in pair-major storage, on
    a mesh the rank's own slots (``block_cyclic.PairPlacement``), the rest
    replicated."""
    from ..lowerables import Spec

    m = n * p
    nb = choose_tile_size(m, tile_size, multiple_of=p)
    T = m // nb
    kmax = min(max_rank, nb) if max_rank > 0 else max(8, nb // 4)
    layout = pair_layout(T, pair_shards(mesh, row_axes))

    def fn(diag_l, u, v, ranks, alpha, locs, pred_locs):
        shard = pair_shard(mesh, row_axes)
        factor = CokrigeFactor(
            diag_l=diag_l, u=u, v=v, ranks=ranks, alpha=alpha, locs=locs,
            params=params, kind="tlr", n_shards=layout.n_shards,
            shard=None if shard is None else shard.index,
        )
        with torch.no_grad():
            out = predict_with_factor(
                factor, pred_locs, interval=interval, gen=gen, mesh=mesh,
                row_axes=tuple(row_axes),
            )
        return out.mean, out.variance, out.lower, out.upper

    specs = (
        Spec((T, nb, nb), dtype),
        Spec((layout.length, nb, kmax), dtype),
        Spec((layout.length, nb, kmax), dtype),
        Spec((layout.length,), torch.int32),
        Spec((m,), dtype),
        Spec((n, 2), dtype),
        Spec((batch, 2), dtype),
    )
    return fn, specs

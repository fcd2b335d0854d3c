"""MLE driver: parameter transforms + objective + fit loop (exact/TLR/DST).

Counterpart of ``repro.core.mle``.  A gradient-free optimizer (Nelder–Mead,
standing in for the paper's NLOPT/BOBYQA) over transformed parameters, with
the log-likelihood backend one of

  * "exact" — dense Cholesky (Eq. 1),
  * "tlr"   — Tile Low-Rank Cholesky at accuracy 1e-5/1e-7/1e-9 (§5.3),
  * "dst"   — Diagonal Super Tile baseline (§4.4).

Transforms: log for sigma^2 / a / nu, atanh for beta_ij.  The profile mode
(§5.2) drops the p marginal variances from the search space and recovers
them in closed form after convergence.  The optimizer's vectors live on
the CPU; the objective moves them to the data's device, where the
likelihood runs, and returns a 0-d tensor there.

``dist_tlr_from_tiles`` routes the TLR backend through
``core.dist_tlr.dist_tlr_loglik`` (with ``block_cyclic``, ``super_panels``
and ``shard_svd``), and ``dtype_policy`` reaches both TLR backends, as in
the reference.  ``checkpoint_dir`` in ``fit`` makes the search
crash-tolerant (``optimize.multistart_nelder_mead``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .covariance import GENERATORS, MaternParams, morton_order, pairwise_distances
from .dist_tlr import dist_tlr_loglik
from .dst import dst_loglik
from .likelihood import exact_loglik, profile_variances
from .optimize import multistart_nelder_mead, nelder_mead
from .recovery import find_duplicate_locations, jitter_escalate
from .tlr import tlr_loglik

BACKENDS = ("exact", "tlr", "dst")


@dataclasses.dataclass(frozen=True)
class MLEConfig:
    p: int = 2
    representation: str = "I"
    nugget: float = 1e-8
    profile: bool = True
    backend: str = "exact"  # exact | tlr | dst
    tlr_tol: float = 1e-7  # TLR5/7/9 <-> 1e-5/1e-7/1e-9
    tlr_max_rank: int = 64
    # Generator-direct TLR (tlr_compress_tiles): never builds the dense Sigma.
    tlr_from_tiles: bool = False
    # Route the TLR backend through core.dist_tlr.dist_tlr_loglik (the
    # distributed pipeline's forms, without a mesh); generator-direct like
    # tlr_from_tiles.  block_cyclic (pair-major storage), super_panels
    # (two-level factorization) and shard_svd are read by that path only;
    # without a mesh shard_svd selects nothing.
    dist_tlr_from_tiles: bool = False
    block_cyclic: bool = False
    super_panels: int = 1
    shard_svd: bool = True
    # Mixed-precision storage policy for both TLR backends (core.precision):
    # None keeps one dtype; "mixed_f32" stores off-diagonal U/V (and runs
    # their SVDs, GEMMs and recompressions) in float32 while the diagonal
    # tiles, POTRF/TRSM and the logdet stay float64.
    dtype_policy: str | None = None
    # Tile generator: "kernel" (the matern_tile kernel from the locations)
    # or "plain" (distances, then the matern_corr kernel) — the reference's
    # "pallas" / "xla".
    gen: str = "kernel"
    tile_size: int = 0  # 0 -> auto (~sqrt(pn))
    dst_keep_fraction: float = 0.7  # DST 70/30
    max_iters: int = 150
    nu_max: float = 4.0
    # Morton-sort locations before tiling (§5.3).  The exact likelihood is
    # permutation-invariant, so this is always safe.
    morton: bool = True
    # Jitter-escalation retry (core/recovery.py): when a factorization
    # breaks (status not ok or a non-finite loglik), re-evaluate with the
    # nugget bumped along an additive ladder initial -> *factor capped at
    # max_jitter.  Off by default, as in the reference; without it a broken
    # factorization still degrades safely (finite penalty, never NaN).
    recovery: bool = False
    recovery_initial_jitter: float = 1e-8
    recovery_factor: float = 10.0
    recovery_max_jitter: float = 1e-2
    recovery_max_attempts: int = 6
    # Pre-flight duplicate/near-duplicate location check in ``fit``.
    check_duplicates: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.gen not in GENERATORS:
            raise ValueError(f"gen must be one of {GENERATORS}, got {self.gen!r}")


def n_free_params(p: int, profile: bool) -> int:
    base = 1 + p + p * (p - 1) // 2  # a, nu_i, beta_ij
    return base if profile else base + p


def pack_params(params: MaternParams, profile: bool) -> torch.Tensor:
    p = params.p
    iu, ju = np.triu_indices(p, k=1)
    parts = []
    if not profile:
        parts.append(torch.log(params.sigma2))
    parts.append(torch.log(params.a)[None])
    parts.append(torch.log(params.nu))
    if p > 1:
        parts.append(torch.arctanh(params.beta[iu, ju]))
    return torch.cat(parts)


def unpack_params(x, p: int, profile: bool, nu_max: float = 4.0) -> MaternParams:
    """Parameters from a transformed vector, on ``x``'s device."""
    x = torch.as_tensor(x)
    kw = dict(dtype=x.dtype, device=x.device)
    iu, ju = np.triu_indices(p, k=1)
    i = 0
    if profile:
        sigma2 = torch.ones((p,), **kw)
    else:
        sigma2 = torch.exp(x[i : i + p])
        i += p
    a = torch.exp(x[i])
    i += 1
    # Clipped-log nu keeps K_nu evaluations stable at simplex extremes.
    nu = torch.clamp(torch.exp(x[i : i + p]), 1e-2, nu_max)
    i += p
    beta = torch.eye(p, **kw)
    if p > 1:
        vals = torch.tanh(x[i:])
        beta[iu, ju] = vals
        beta[ju, iu] = vals
    return MaternParams(sigma2=sigma2, a=a, nu=nu, beta=beta)


def initial_guess(
    p: int, profile: bool, a0=0.1, nu0=1.0, dtype=torch.float64, device="cpu"
) -> torch.Tensor:
    """The default start: unit variances, range a0, smoothness nu0 and
    cross-correlation 0.1, packed.  On the CPU by default, where the
    optimizer keeps its simplex."""
    kw = dict(dtype=dtype, device=device)
    eye = torch.eye(p, **kw)
    params = MaternParams(
        sigma2=torch.ones((p,), **kw),
        a=torch.tensor(a0, **kw),
        nu=torch.full((p,), nu0, **kw),
        beta=eye * 1.0 + (torch.ones((p, p), **kw) - eye) * 0.1,
    )
    return pack_params(params, profile)


class FitResult(NamedTuple):
    params: MaternParams
    loglik: torch.Tensor
    n_iters: int
    n_evals: int
    converged: bool
    clamped_evals: torch.Tensor | None = None  # evals clamped to the penalty
    recovery_retries: torch.Tensor | None = None  # total jitter-ladder retries


class ObjectiveAux(NamedTuple):
    """Per-evaluation fault counters threaded out of the objective."""

    clamped: torch.Tensor  # int32: 1 if this eval returned the penalty value
    retries: torch.Tensor  # int32: jitter-ladder retries this eval performed
    breakdowns: torch.Tensor  # int32: 1 if the clean first attempt broke


def _backend_loglik(
    dists, z, params: MaternParams, cfg: MLEConfig, locs=None, extra_nugget=None
):
    """Full LoglikResult from the configured backend.

    ``extra_nugget`` is *added* to ``cfg.nugget`` — the jitter-escalation
    ladder uses it.
    """
    nugget = cfg.nugget if extra_nugget is None else cfg.nugget + extra_nugget
    if cfg.backend == "exact":
        return exact_loglik(
            None,
            z,
            params,
            representation=cfg.representation,
            nugget=nugget,
            dists=dists,
        )
    if cfg.backend == "tlr":
        if cfg.dist_tlr_from_tiles:
            if locs is None:
                raise ValueError("dist_tlr_from_tiles requires locs (Morton-ordered)")
            return dist_tlr_loglik(
                None,
                z,
                locs=locs,
                params=params,
                from_tiles=True,
                tile_size=cfg.tile_size,
                max_rank=cfg.tlr_max_rank,
                nugget=nugget,
                gen=cfg.gen,
                tol=cfg.tlr_tol,
                super_panels=cfg.super_panels,
                block_cyclic=cfg.block_cyclic,
                shard_svd=cfg.shard_svd,
                dtype_policy=cfg.dtype_policy,
            )
        return tlr_loglik(
            dists,
            z,
            params,
            tol=cfg.tlr_tol,
            max_rank=cfg.tlr_max_rank,
            tile_size=cfg.tile_size,
            nugget=nugget,
            locs=locs,
            from_tiles=cfg.tlr_from_tiles,
            gen=cfg.gen,
            dtype_policy=cfg.dtype_policy,
        )
    if cfg.backend == "dst":
        return dst_loglik(
            dists,
            z,
            params,
            keep_fraction=cfg.dst_keep_fraction,
            tile_size=cfg.tile_size,
            nugget=nugget,
            representation=cfg.representation,
        )
    raise ValueError(f"unknown backend {cfg.backend!r}")


def apply_morton(locs, z, p: int, representation: str = "I"):
    """Morton-sort locations and permute z consistently.  ``locs`` is host
    data (numpy, or a tensor brought to the host); ``z`` keeps its kind
    (a tensor stays on its device)."""
    if isinstance(locs, torch.Tensor):
        locs = locs.detach().cpu().numpy()
    locs = np.asarray(locs)
    perm = morton_order(locs)
    n = locs.shape[0]
    if representation.upper() == "I":
        idx = (perm[:, None] * p + np.arange(p)[None, :]).reshape(-1)
    else:
        idx = (np.arange(p)[:, None] * n + perm[None, :]).reshape(-1)
    if isinstance(z, torch.Tensor):
        zn = z[torch.as_tensor(idx, device=z.device)]
    else:
        zn = np.asarray(z)[idx]
    return locs[perm], zn


def make_objective(locs, z, cfg: MLEConfig, dists=None, with_aux=False, *, device=None):
    """Negative log-likelihood over transformed parameters, as a callable.

    Callers must pass Morton-consistent (locs, z) for tiled backends;
    ``fit`` handles that via apply_morton.  The generator-direct TLR
    backends (tlr_from_tiles or dist_tlr_from_tiles, non-profile) never
    read the dense (n, n) distance matrix, so it is not built for them.
    Numpy data go to ``device``; a tensor ``z`` decides the device
    otherwise.

    A broken or non-finite evaluation never leaks NaN: with ``cfg.recovery``
    the jitter-escalation ladder retries, and whatever survives is clamped
    to the finite dtype-aware penalty ``sqrt(finfo.max)``.  With
    ``with_aux=True`` the objective returns ``(value, ObjectiveAux)``.
    Returns ``(objective, dists)``.
    """
    if isinstance(z, torch.Tensor) and device is None:
        device = z.device
    dev = resolve_device(device)
    generator_direct = (
        cfg.backend == "tlr"
        and not cfg.profile
        and (cfg.tlr_from_tiles or cfg.dist_tlr_from_tiles)
    )
    locs_t = None if locs is None else as_tensor(locs, device=dev)
    if dists is None and not generator_direct:
        dists = pairwise_distances(locs_t)
    elif dists is not None:
        dists = as_tensor(dists, device=dev)
    z = as_tensor(z, device=dev)
    dtype = z.dtype
    penalty = torch.finfo(dtype).max ** 0.5

    def eval_at(x, jitter: float):
        params = unpack_params(x, cfg.p, cfg.profile, cfg.nu_max)
        if cfg.profile:
            sigma2 = profile_variances(
                dists,
                z,
                params.a,
                params.nu,
                cfg.p,
                nugget=cfg.nugget + jitter,
                representation=cfg.representation,
            )
            params = params._replace(sigma2=sigma2)
        res = _backend_loglik(dists, z, params, cfg, locs=locs_t, extra_nugget=jitter)
        ll = res.loglik
        ok = torch.isfinite(ll)
        if res.status is not None:
            ok = ok & res.status.ok
        return ll, ok

    def neg_ll(x):
        x = torch.as_tensor(x).to(device=dev, dtype=dtype)
        if cfg.recovery:
            rec = jitter_escalate(
                lambda j: eval_at(x, j),
                initial=cfg.recovery_initial_jitter,
                factor=cfg.recovery_factor,
                max_jitter=cfg.recovery_max_jitter,
                max_attempts=cfg.recovery_max_attempts,
                dtype=dtype,
            )
            ll, ok = rec.loglik, rec.ok
            retries = rec.attempts - 1
        else:
            ll, ok = eval_at(x, 0.0)
            retries = torch.zeros((), dtype=torch.int32)
        good = ok & torch.isfinite(ll)
        val = torch.where(good, -ll, penalty)
        if not with_aux:
            return val
        aux = ObjectiveAux(
            clamped=(~good).to(torch.int32).cpu(),
            retries=torch.as_tensor(retries, dtype=torch.int32),
            breakdowns=((retries > 0) | ~good.cpu()).to(torch.int32),
        )
        return val, aux

    return neg_ll, dists


def check_locations(locs, tol=None):
    """Raise ValueError naming duplicate / near-duplicate location rows."""
    if locs is None:
        return
    pairs = find_duplicate_locations(locs, tol=tol)
    if pairs:
        shown = ", ".join(f"({i}, {j})" for i, j in pairs[:8])
        more = "" if len(pairs) <= 8 else f" (+{len(pairs) - 8} more)"
        raise ValueError(
            f"{len(pairs)} duplicate/near-duplicate location pair(s): "
            f"{shown}{more} — Sigma is singular at these rows regardless of "
            "parameters.  De-duplicate the locations, or pass "
            "MLEConfig(check_duplicates=False) to rely on jitter recovery."
        )


def fit(
    locs,
    z,
    cfg: MLEConfig,
    x0=None,
    dists=None,
    n_starts: int = 1,
    seed: int = 0,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    *,
    device=None,
) -> FitResult:
    """Run the full estimation (the paper's 'MLE operation').

    ``n_starts > 1`` runs a multistart (perturbed initial guesses, keep the
    best); ``checkpoint_dir`` makes the multistart crash-tolerant: the
    per-start simplex state is checkpointed every ``checkpoint_every``
    iterations (0 = once per completed start) and a re-run resumes instead
    of restarting.  Numpy data go to ``device`` (the CUDA device by
    default).
    """
    if cfg.check_duplicates:
        check_locations(locs)
    if cfg.morton and dists is None and locs is not None:
        locs, z = apply_morton(locs, z, cfg.p, cfg.representation)
    if isinstance(z, torch.Tensor) and device is None:
        device = z.device
    z = as_tensor(z, device=resolve_device(device))
    neg_ll, dists = make_objective(locs, z, cfg, dists=dists, with_aux=True)
    if x0 is None:
        x0 = initial_guess(cfg.p, cfg.profile, dtype=z.dtype)
    x0 = torch.as_tensor(x0).detach().cpu()
    if n_starts > 1 or checkpoint_dir is not None:
        rng = np.random.default_rng(seed)
        x0s = [x0] + [
            x0 + torch.as_tensor(rng.normal(scale=0.25, size=x0.shape), dtype=x0.dtype)
            for _ in range(n_starts - 1)
        ]
        res = multistart_nelder_mead(
            neg_ll,
            x0s,
            max_iters=cfg.max_iters,
            has_aux=True,
            aux_template=ObjectiveAux(*[torch.zeros((), dtype=torch.int32)] * 3),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
        )
    else:
        res = nelder_mead(neg_ll, x0, max_iters=cfg.max_iters, has_aux=True)
    params = unpack_params(res.x.to(z.device), cfg.p, cfg.profile, cfg.nu_max)
    if cfg.profile:
        sigma2 = profile_variances(
            dists,
            z,
            params.a,
            params.nu,
            cfg.p,
            nugget=cfg.nugget,
            representation=cfg.representation,
        )
        params = params._replace(sigma2=sigma2)
    clamped = retries = None
    if res.aux is not None:
        clamped = res.aux.clamped
        retries = res.aux.retries
    return FitResult(
        params, -res.value, res.n_iters, res.n_evals, res.converged, clamped, retries
    )

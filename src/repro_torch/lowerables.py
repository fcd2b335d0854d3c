"""Registry of lowerable entry points: ``name -> Lowerable(fn, specs,
in_shardings, donate_argnums, ...)``.

Counterpart of ``repro.lowerables``.  The dry-run (``launch.dryrun``), the
lint layer that reads its traces (ROADMAP Queue 1 item 8) and the serving
cells need the same thing: a function, its inputs' global (shape, dtype)
stand-ins (``Spec``), their placements on the mesh and
which inputs the function updates in place, built for a (shape, mesh) pair.
A constructor registers once (``@register``); ``build(name, shape, mesh)``
returns the ready ``{cell_name: Lowerable}`` dict (one registration may
give several cells: ``cokrige_serving`` gives the fit and predict phases)
and ``names()`` lists the registrations.

The port has no compiler, so "lowering" a cell is tracing it: the dry-run
calls ``fn`` on fake tensors at each input's local shape
(``placement.local_shape(spec.shape)``), and the card runs it on real ones.
``in_shardings`` holds the port's placements where the reference has
``NamedSharding``s: a replicated ``distribution.sharding.Sharding`` (every
rank passes the whole input, as the port's mesh forms take it) or the
rank's own pair slots (``block_cyclic.PairPlacement``).
``donate_argnums`` names the inputs that ``fn`` overwrites with its result
(the reference's donation, an in-place update here).  ``config`` stays
None: it is the lint layer's.

The parameters and every input are float32 by default, as the
reference's (the ``fma_f32`` instances of the kernels on the card), on
the mesh's device type.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

__all__ = ["Spec", "Lowerable", "register", "build", "names"]


class Spec(NamedTuple):
    """A lowerable input's global (shape, dtype) stand-in (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: Any


class Lowerable(NamedTuple):
    """Everything a consumer needs to trace or run one entry point."""

    fn: Callable
    specs: tuple  # the inputs' global Spec(shape, dtype)
    in_shardings: tuple  # each input's placement on the mesh
    donate_argnums: tuple = ()  # the inputs fn updates in place
    matrix_dim: int | None = None  # the lint layer's densification bar
    config: Any = None  # the lint layer's configuration (None: default)


_BUILDERS: dict[str, Callable] = {}


def register(name: str):
    """Register ``builder(shape, mesh) -> Lowerable | {name: Lowerable}``."""

    def deco(builder):
        _BUILDERS[name] = builder
        return builder

    return deco


def names() -> tuple:
    return tuple(_BUILDERS)


def build(name: str, shape, mesh, dtype_policy=None) -> dict:
    """Build one registered target: ``{cell_name: Lowerable}`` (single-cell
    targets key on their own name).  ``dtype_policy`` (a
    ``core.precision`` policy name) builds the target under that
    mixed-precision storage contract; a target whose builder does not take
    it refuses a policy with KeyError."""
    if name not in _BUILDERS:
        raise KeyError(
            f"unknown lowerable target {name!r} "
            f"(registered: {', '.join(sorted(_BUILDERS))})"
        )
    builder = _BUILDERS[name]
    if dtype_policy is not None:
        import inspect

        if "dtype_policy" not in inspect.signature(builder).parameters:
            raise KeyError(f"target {name!r} does not support a dtype policy")
        out = builder(shape, mesh, dtype_policy=dtype_policy)
    else:
        out = builder(shape, mesh)
    if isinstance(out, Lowerable):
        return {name: out}
    return dict(out)


# ---------------------------------------------------------------------------
# Shared geometry / parameter helpers
# ---------------------------------------------------------------------------


def _row_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _params(mesh, dtype=None):
    import torch

    from .core.covariance import MaternParams

    return MaternParams.bivariate(
        a=0.09,
        nu11=0.5,
        nu22=2.5,
        beta=0.5,
        dtype=torch.float32 if dtype is None else dtype,
        device=mesh.device_type,
    )


def _policy_wide(dtype_policy):
    """The policy's wide dtype, or None without a policy."""
    if dtype_policy is None:
        return None
    from .core.precision import resolve_policy

    return resolve_policy(dtype_policy).wide_dtype


def _tlr_geometry(m: int):
    """(tile_size, max_rank) scaled down for small dev shapes."""
    from .configs.geostat import GEOSTAT_TLR as cfg

    nb = max(64, min(cfg.tile_size, m // 32))
    return nb, min(cfg.max_rank, nb // 2)


def _rep(mesh):
    from .distribution.sharding import Sharding

    return Sharding(mesh, ())


# ---------------------------------------------------------------------------
# Registrations
# ---------------------------------------------------------------------------


@register("dist_tlr_pipeline_lowerable")
def _tlr_pipeline(shape, mesh, dtype_policy=None):
    from .configs.geostat import GEOSTAT_TLR as cfg
    from .core.dist_tlr import dist_tlr_pipeline_lowerable

    m = shape.matrix_dim
    nb, kmax = _tlr_geometry(m)
    fn, specs = dist_tlr_pipeline_lowerable(
        shape.n_locations,
        shape.p,
        _params(mesh, _policy_wide(dtype_policy)),
        tile_size=nb,
        max_rank=kmax,
        tol=cfg.tol,
        nugget=1e-8,
        mesh=mesh,
        row_axes=_row_axes(mesh),
        super_panels=cfg.super_panels,
        block_cyclic=cfg.block_cyclic,
        dtype_policy=dtype_policy,
    )
    return Lowerable(fn, specs, (_rep(mesh),) * 2, matrix_dim=m)


@register("dist_tlr_gen_lowerable")
def _tlr_gen(shape, mesh, dtype_policy=None):
    import torch

    from .core.dist_tlr import dist_tlr_gen_lowerable

    m = shape.matrix_dim
    nb, _ = _tlr_geometry(m)
    wide = _policy_wide(dtype_policy)
    fn, specs = dist_tlr_gen_lowerable(
        shape.n_locations,
        shape.p,
        _params(mesh, wide),
        tile_size=nb,
        mesh=mesh,
        row_axes=_row_axes(mesh),
        dtype=torch.float32 if wide is None else wide,
    )
    return Lowerable(fn, specs, (_rep(mesh),), matrix_dim=m)


@register("dist_tlr_compress_lowerable")
def _tlr_compress(shape, mesh, dtype_policy=None):
    from .configs.geostat import GEOSTAT_TLR as cfg
    from .core.dist_tlr import dist_tlr_compress_lowerable

    m = shape.matrix_dim
    nb, kmax = _tlr_geometry(m)
    fn, specs = dist_tlr_compress_lowerable(
        shape.n_locations,
        shape.p,
        _params(mesh, _policy_wide(dtype_policy)),
        tile_size=nb,
        max_rank=kmax,
        tol=cfg.tol,
        nugget=1e-8,
        mesh=mesh,
        row_axes=_row_axes(mesh),
        block_cyclic=cfg.block_cyclic,
        shard_svd=True,
        dtype_policy=dtype_policy,
    )
    return Lowerable(fn, specs, (_rep(mesh),), matrix_dim=m)


@register("dist_tlr_lowerable")
def _tlr_factorize(shape, mesh, dtype_policy=None):
    from .configs.geostat import GEOSTAT_TLR as cfg
    from .core.dist_tlr import dist_tlr_in_shardings, dist_tlr_lowerable

    row = _row_axes(mesh)
    m = shape.matrix_dim
    nb, kmax = _tlr_geometry(m)
    fn, specs = dist_tlr_lowerable(
        m // nb,
        nb,
        kmax,
        tol=cfg.tol,
        mesh=mesh,
        row_axes=row,
        super_panels=cfg.super_panels,
        block_cyclic=cfg.block_cyclic,
        return_factor=True,
        dtype_policy=dtype_policy,
    )
    sh = dist_tlr_in_shardings(mesh=mesh, row_axes=row, block_cyclic=cfg.block_cyclic)
    return Lowerable(fn, specs, sh, donate_argnums=(0, 1, 2, 3), matrix_dim=m)


@register("dist_loglik_lowerable")
def _exact_loglik(shape, mesh):
    from .core.dist_cholesky import dist_loglik_lowerable

    m = shape.matrix_dim
    panel = max(512, m // 64)
    fn, specs = dist_loglik_lowerable(
        shape.n_locations,
        shape.p,
        _params(mesh),
        panel=panel,
        mesh=mesh,
        row_axes=_row_axes(mesh),
    )
    # the exact backend is dense by contract
    return Lowerable(fn, specs, (_rep(mesh),) * 2, matrix_dim=None)


@register("dist_cokrige_lowerable")
def _exact_cokrige(shape, mesh):
    from .core.dist_cholesky import dist_cokrige_lowerable

    m = shape.matrix_dim
    n_pred = getattr(shape, "n_pred", 0) or max(shape.n_locations // 16, 256)
    panel = max(512, m // 64)
    fn, specs = dist_cokrige_lowerable(
        shape.n_locations,
        n_pred,
        shape.p,
        _params(mesh),
        panel=panel,
        mesh=mesh,
        row_axes=_row_axes(mesh),
    )
    return Lowerable(fn, specs, (_rep(mesh),) * 3, matrix_dim=None)


@register("cokrige_serving")
def _cokrige_serving(shape, mesh):
    """The two serving phases (``serving.cokrige_service``): prefill
    (``serve_fit``) and decode (``serve_predict``, B = 512).  The factor
    inputs of the decode cell are not updated: reuse across request
    batches is the serving contract."""
    from .configs.geostat import GEOSTAT_TLR as cfg
    from .distribution.block_cyclic import PairPlacement
    from .serving.cokrige_service import (
        cokrige_fit_lowerable,
        cokrige_predict_lowerable,
    )

    row = _row_axes(mesh)
    m = shape.matrix_dim
    nb, kmax = _tlr_geometry(m)
    params = _params(mesh)
    rep = _rep(mesh)

    fit_fn, fit_specs = cokrige_fit_lowerable(
        shape.n_locations,
        shape.p,
        params,
        tile_size=nb,
        max_rank=kmax,
        tol=cfg.tol,
        nugget=1e-8,
        mesh=mesh,
        row_axes=row,
    )
    fit = Lowerable(fit_fn, fit_specs, (rep, rep), matrix_dim=m)

    pred_fn, pred_specs = cokrige_predict_lowerable(
        shape.n_locations,
        shape.p,
        params,
        tile_size=nb,
        max_rank=kmax,
        batch=512,
        mesh=mesh,
        row_axes=row,
    )
    pairs = PairPlacement(mesh, row)
    pred = Lowerable(
        pred_fn,
        pred_specs,
        # diag_l, u, v, ranks, alpha, observed and predicted locations
        (rep, pairs, pairs, pairs, rep, rep, rep),
        matrix_dim=m,
    )
    return {"serve_fit": fit, "serve_predict": pred}

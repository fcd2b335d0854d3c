"""Rank bodies of tests/test_torch_mesh.py (not collected by pytest).

The mesh tests start W rank processes (``launch.mesh.spawn_ranks``); each
unpickles ``run_all`` from this module, so it imports only numpy, torch and
the port, never JAX.  ``inputs`` builds the cases' numpy inputs from seeds,
the same in the parent and in every rank; ``run_all`` runs every case once
on the mesh and returns what the parent asserts on, as numpy.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
NUGGET = 1e-8
# test_torch_dist_tlr.py's geometry: n = 144, tile 48, T = 6
SMALL = dict(side=12, tile=48)
# the reference's acceptance geometry: n = 256, m = 512, tile 64
ACCEPT = dict(side=16, tile=64)
EXACT_PANEL = 64
SERVE = dict(tile_size=64, max_rank=24, tol=1e-7, nugget=NUGGET, gen="kernel")
LADDER = dict(initial=1e-6, factor=10.0, max_jitter=1e-2, max_attempts=4)
CHOL_FORMS = {
    "masked": {},
    "super3": dict(super_panels=3),
    "block_cyclic": dict(block_cyclic=True),
    "block_cyclic_super3": dict(block_cyclic=True, super_panels=3),
    "block_cyclic_replicated": dict(block_cyclic=True, shard_recompress=False),
}
LOGLIK_FORMS = {
    "masked": {},
    "block_cyclic": dict(block_cyclic=True),
    "block_cyclic_super3_cb2": dict(block_cyclic=True, super_panels=3, col_block=2),
    "replicated": dict(block_cyclic=True, shard_svd=False, shard_recompress=False),
    "mixed_f32": dict(block_cyclic=True, dtype_policy="mixed_f32"),
}
NAN_SLOT = 5
# the recompress slot a NaN is put into for the subset-axes count
NAN_PAIR = 3


def locations(side: int, dups: int = 0) -> np.ndarray:
    from repro_torch.core.covariance import morton_order
    from repro_torch.core.simulate import grid_locations

    locs = grid_locations(side, jitter=0.2, seed=0)
    if dups:
        locs[-dups:] = locs[:dups]
    return locs[morton_order(locs)]


def params():
    from repro_torch.core.covariance import MaternParams

    return MaternParams.bivariate(**PARAMS, device="cpu")


def inputs() -> dict:
    """The numpy inputs of every case, made from seeds."""
    from repro_torch.core.simulate import simulate_mgrf

    rng = np.random.default_rng(7)
    small, accept, dup = locations(SMALL["side"]), locations(ACCEPT["side"]), None
    u1, v1, u2, v2 = (rng.normal(size=(10, 16, 4)) for _ in range(4))
    u1[..., -1:] = 0.0  # a padded rank column
    v1[..., -1:] = 0.0
    lowrank = rng.normal(size=(7, 16, 5)) @ rng.normal(size=(7, 5, 16))
    dup = locations(ACCEPT["side"], dups=4)
    m = 2 * len(accept)
    sim = lambda x, seed: simulate_mgrf(  # noqa: E731
        None, x, params(), nugget=NUGGET, device="cpu",
        eps=torch.as_tensor(np.random.default_rng(seed).normal(size=(1, m))),
    )[0].numpy()
    d = accept[:, None, :] - accept[None, :, :]
    return dict(
        recompress=(u1, v1, u2, v2),
        tiles=lowrank + 1e-9 * rng.normal(size=lowrank.shape),
        small=small,
        z_small=np.random.default_rng(2).normal(size=2 * len(small)),
        accept=accept,
        dists=np.sqrt(np.maximum((d * d).sum(-1), 0.0)),
        z_accept=sim(accept, 0),
        rhs=np.random.default_rng(0).normal(size=(m, 3)),
        pred=np.random.default_rng(3).uniform(0.05, 0.95, size=(48, 2)),
        dup=dup,
        z_dup=sim(dup, 0),
    )


def products(u, v) -> np.ndarray:
    """U V^T of every tile (the sign-free comparison of two SVDs)."""
    return np.einsum("...nk,...mk->...nm", np.asarray(u), np.asarray(v))


@contextlib.contextmanager
def counting(module, name: str, counts: list, size=lambda out, *a: 1):
    """Append ``size(out, *args)`` of every call of ``module.name``."""
    plain = getattr(module, name)

    def wrapped(*args, **kw):
        out = plain(*args, **kw)
        counts.append(size(out, *args))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, plain)


def _status(st) -> dict:
    return None if st is None else st.as_dict()


def _grid(t, layout) -> dict:
    """A TLRMatrix or a (gathered) PairTLR as grid products and ranks."""
    from repro_torch.core.dist_tlr import PairTLR

    if isinstance(t, PairTLR):
        t = t.to_grid(layout)
    return dict(diag=t.diag, uv=products(t.u, t.v), ranks=t.ranks)


def case_batches(mesh, x) -> dict:
    from repro_torch.distribution.block_cyclic import pair_axis
    from repro_torch.distribution.compress_svd import sharded_truncate_svd
    from repro_torch.distribution.pair_qr import sharded_recompress

    axes = pair_axis(mesh)
    parts = [torch.as_tensor(a) for a in x["recompress"]]
    un, vn, rn, bad = sharded_recompress(
        *parts, 1e-6, 1.0, mesh=mesh, axes=axes, with_count=True
    )
    out = dict(recompress=dict(uv=products(un, vn), ranks=rn, bad=bad))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        un, vn, rn = sharded_recompress(
            *parts, 1e-6, 1.0, mesh=mesh, axes=axes, pad=False
        )
    out["recompress_nopad"] = dict(
        uv=products(un, vn), ranks=rn, warned=[str(w.message) for w in caught]
    )
    tiles = torch.as_tensor(x["tiles"])
    U, V, R = sharded_truncate_svd(tiles, 1e-7, 8, 1.0, mesh=mesh, axes=axes)
    out["svd"] = dict(uv=products(U, V), ranks=R)
    # sharded over "data" alone, replicated over "model"; a NaN slot counted
    sub = ("data",) if mesh is not None else None
    parts[0] = parts[0].clone()
    parts[0][NAN_PAIR, 0, 0] = float("nan")
    un, vn, rn, bad = sharded_recompress(
        *parts, 1e-6, 1.0, mesh=mesh, axes=sub, with_count=True
    )
    out["recompress_subset"] = dict(uv=products(un, vn), ranks=rn, bad=bad)
    U, V, R = sharded_truncate_svd(tiles, 1e-7, 8, 1.0, mesh=mesh, axes=sub)
    out["svd_subset"] = dict(uv=products(U, V), ranks=R)
    return out


def case_compress(mesh, x) -> dict:
    from repro_torch.core import dist_tlr as td
    from repro_torch.distribution.block_cyclic import pair_layout, pair_shards

    T = 2 * len(x["small"]) // SMALL["tile"]
    layout = pair_layout(T, pair_shards(mesh))
    kw = dict(tile_size=SMALL["tile"], tol=1e-9, max_rank=48, nugget=NUGGET,
              gen="plain", device="cpu", mesh=mesh)
    tiles = []
    with counting(td, "svd_truncate_batch", tiles, lambda out, b, *a: b.shape[0]):
        own = td.dist_compress_tiles(x["small"], params(), layout=layout, **kw)
    full = td.gather_pair_tlr(own, mesh)
    grid = td.dist_compress_tiles(x["small"], params(), **kw)
    return dict(
        compress_pairs=dict(
            **_grid(full, layout), shard=own.shard, held=own.u.shape[0],
            tiles_svd=sum(tiles),
        ),
        compress_grid=_grid(grid, None),
    )


def case_cholesky(mesh, carried, forms=tuple(CHOL_FORMS)) -> dict:
    from repro_torch.core import dist_tlr as td
    from repro_torch.core import tlr as tt
    from repro_torch.distribution.block_cyclic import (
        gather_pairs, grid_to_pairs, pair_layout, pair_shard, pair_shards,
    )

    diag, u, v = (torch.as_tensor(a) for a in carried[:3])
    ranks = torch.as_tensor(carried[3], dtype=torch.int32)
    kw = dict(tol=1e-11, scale=1.0, track_status=True, mesh=mesh)
    out = {}
    for name in forms:
        form, pairs = CHOL_FORMS[name], []
        size = lambda res, *a: int(a[0].shape[0])  # noqa: E731
        with counting(tt, "sharded_recompress", pairs, size):
            got = td.dist_tlr_cholesky(diag, u, v, ranks, **kw, **form)
        out[name] = dict(
            diag=got[0], uv=products(got[1], got[2]), ranks=got[3],
            status=_status(got[4]), pairs_recompressed=sum(pairs),
        )
    # the pair API: the whole slots in, the rank's own slots out
    layout = pair_layout(diag.shape[0], pair_shards(mesh))
    shard = pair_shard(mesh)
    res = td.dist_tlr_cholesky_pairs(
        diag, *(grid_to_pairs(a, layout) for a in (u, v, ranks)), layout=layout, **kw
    )
    full = [gather_pairs(a, shard) for a in res[1:4]]
    t = td.PairTLR(res[0], *full, n_shards=layout.n_shards).to_grid(layout)
    out["pairs"] = dict(
        diag=t.diag, uv=products(t.u, t.v), ranks=t.ranks, status=_status(res[4]),
        held=res[1].shape[0],
    )
    return out


def case_loglik(
    mesh, x, carried, forms=tuple(LOGLIK_FORMS), from_grid: bool = True
) -> dict:
    from repro_torch import convert
    from repro_torch.core import dist_tlr as td

    kw = dict(tile_size=SMALL["tile"], max_rank=48, nugget=NUGGET, tol=1e-7,
              gen="plain", device="cpu", mesh=mesh)
    out = {}
    for name in forms:
        res = td.dist_tlr_loglik(
            None, x["z_small"], locs=x["small"], params=params(), from_tiles=True,
            **kw, **LOGLIK_FORMS[name],
        )
        out[name] = dict(loglik=res.loglik, logdet=res.logdet, quad=res.quad,
                         status=_status(res.status))
    if not from_grid:
        return out
    t = convert.tlr_matrix_from_numpy(*carried, device="cpu")
    for name, form in (("from_grid", {}), ("from_grid_bc", dict(block_cyclic=True))):
        res = td.dist_tlr_loglik(
            t, x["z_small"], tol=1e-12, scale=1.0, mesh=mesh, **form
        )
        out[name] = dict(loglik=res.loglik, logdet=res.logdet, quad=res.quad,
                         status=_status(res.status))
    return out


def case_exact(mesh, x) -> dict:
    from repro_torch.core import dist_cholesky as dc
    from repro_torch.core.covariance import build_sigma

    rows = []
    size = lambda out, *a: a[4]  # noqa: E731  (r0 of each block row)
    with counting(dc, "_sigma_rows", rows, size):
        res = dc.dist_exact_loglik(
            x["dists"], x["z_accept"], params(), nugget=NUGGET, panel=EXACT_PANEL,
            mesh=mesh, device="cpu",
        )
    dists = torch.as_tensor(x["dists"])
    sigma = build_sigma(None, params(), nugget=NUGGET, dists=dists)
    panels = dc.blocked_cholesky_panels(sigma, EXACT_PANEL, mesh)
    rhs = torch.as_tensor(x["rhs"])
    return dict(
        loglik=res.loglik, logdet=res.logdet, quad=res.quad,
        rows_built=[r // EXACT_PANEL for r in rows],
        held_rows=[0 if p is None else p.shape[0] for _, p in panels],
        forward=dc.panels_forward_solve(panels, rhs, EXACT_PANEL, mesh),
        forward1=dc.panels_forward_solve(panels, rhs[:, 0], EXACT_PANEL, mesh),
        backward=dc.panels_backward_solve(panels, rhs, EXACT_PANEL, mesh),
        chol=dc.blocked_cholesky(sigma, EXACT_PANEL, mesh),
    )


def case_serve(mesh, x) -> dict:
    from repro_torch.distribution.block_cyclic import (
        gather_pairs, pair_layout, pair_shard, pairs_to_grid,
    )
    from repro_torch.serving import cokrige_service as svc

    cfg = svc.CokrigeServeConfig(**SERVE)
    factor = svc.fit_factor(
        x["accept"], x["z_accept"], params(), cfg, mesh, device="cpu"
    )
    layout = pair_layout(factor.diag_l.shape[0], factor.n_shards)
    grid = pairs_to_grid(gather_pairs(factor.ranks, pair_shard(mesh)), layout)
    out = svc.predict_batch(factor, x["pred"], cfg, mesh)
    fit, predict = svc.make_cokrige_serve_fns(cfg, mesh)
    again = predict(fit(x["accept"], x["z_accept"], params(), device="cpu"), x["pred"],
                    generator=torch.Generator().manual_seed(0), n_draws=4)
    return dict(
        status=_status(factor.status), alpha=factor.alpha, ranks=grid,
        held=factor.u.shape[0], diag_l=factor.diag_l,
        **{f: getattr(out, f) for f in ("mean", "variance", "lower", "upper")},
        again_mean=again.mean, draws=again.draws,
    )


def case_faults(mesh, x) -> dict:
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.recovery import jitter_escalate
    from repro_torch.distribution.block_cyclic import pair_layout, pair_shards
    from repro_torch.serving import cokrige_service as svc
    from repro_torch.testing import corrupt_diag_tile, nan_compress_panel

    kw = dict(locs=x["dup"], params=params(), from_tiles=True, tile_size=64,
              max_rank=24, tol=1e-7, gen="plain", block_cyclic=True, mesh=mesh,
              device="cpu")
    broken = dist_tlr_loglik(z=x["z_dup"], nugget=0.0, **kw)

    def eval_at(j):
        r = dist_tlr_loglik(z=x["z_dup"], nugget=j, **kw)
        return r.loglik, bool(r.status.ok) and bool(torch.isfinite(r.loglik))

    rec = jitter_escalate(eval_at, **LADDER)
    cfg = svc.CokrigeServeConfig(tile_size=64, max_rank=24, tol=1e-7, nugget=NUGGET)
    with corrupt_diag_tile(tile=0, magnitude=10.0):
        factor = svc.fit_factor(x["dup"], x["z_dup"], params(), cfg, mesh, device="cpu")
    try:
        svc.predict_batch(factor, x["pred"][:16], cfg, mesh)
        refused = None
    except svc.ServeError as e:
        refused = dict(code=e.code, status=e.to_dict()["status"])
    T = 2 * len(x["small"]) // SMALL["tile"]
    with nan_compress_panel(NAN_SLOT):
        poisoned = dist_tlr_loglik(
            None, x["z_small"], locs=x["small"], params=params(), from_tiles=True,
            tile_size=SMALL["tile"], max_rank=48, nugget=NUGGET, gen="plain",
            block_cyclic=True, layout=pair_layout(T, pair_shards(mesh)), mesh=mesh,
            device="cpu",
        )
    return dict(
        broken=dict(loglik=broken.loglik, logdet=broken.logdet, quad=broken.quad,
                    status=_status(broken.status)),
        ladder=rec._asdict(),
        fit_status=_status(factor.status),
        refused=refused,
        nan_panel=dict(loglik=poisoned.loglik, status=_status(poisoned.status)),
    )


def case_meshes(mesh) -> dict:
    """A "pod" axis outside the pair axis holds copies of the shards (the
    reference replicates over it); inside it, it splits the pairs."""
    import torch.distributed as dist

    from repro_torch.distribution.block_cyclic import pair_shard, pair_shards
    from repro_torch.launch.mesh import POD_AXES, make_mesh

    world = dist.get_world_size()
    pod = make_mesh((world, 1, 1), POD_AXES, device_type="cpu")
    copy = pair_shard(pod, ("data",))
    return dict(
        pod_outside_row_axes=pair_shards(pod, ("data",)),
        pod_copy_primary=copy.primary,
        rank=dist.get_rank(),
        pod_in_row_axes=pair_shards(pod, ("pod", "data")),
        shape=tuple(mesh.mesh.shape),
        coordinate=tuple(mesh.get_coordinate()),
    )


def case_pod(x) -> dict:
    """The TLR loglik (block-cyclic), serving and the exact form on a
    (2, 1, 2) ("pod", "data", "model") mesh, with row_axes ("data",) (the
    pods hold copies) and ("pod", "data") (the pods split the pairs)."""
    from repro_torch.core import dist_cholesky as dc
    from repro_torch.core import dist_tlr as td
    from repro_torch.distribution.block_cyclic import pair_shards
    from repro_torch.launch.mesh import POD_AXES, make_mesh
    from repro_torch.serving import cokrige_service as svc

    mesh = make_mesh((2, 1, 2), POD_AXES, device_type="cpu")
    out = {}
    for tag, rows in (("data", ("data",)), ("pod_data", ("pod", "data"))):
        res = td.dist_tlr_loglik(
            None, x["z_small"], locs=x["small"], params=params(), from_tiles=True,
            tile_size=SMALL["tile"], max_rank=48, nugget=NUGGET, tol=1e-7,
            gen="plain", device="cpu", mesh=mesh, row_axes=rows,
            **LOGLIK_FORMS["block_cyclic"],
        )
        out[f"loglik_{tag}"] = dict(
            loglik=res.loglik, logdet=res.logdet, quad=res.quad,
            status=_status(res.status), shards=pair_shards(mesh, rows),
        )
        cfg = svc.CokrigeServeConfig(**SERVE, row_axes=rows)
        factor = svc.fit_factor(
            x["accept"], x["z_accept"], params(), cfg, mesh, device="cpu"
        )
        pred = svc.predict_batch(factor, x["pred"], cfg, mesh)
        out[f"serve_{tag}"] = dict(
            status=_status(factor.status), alpha=factor.alpha,
            **{f: getattr(pred, f) for f in ("mean", "variance", "lower", "upper")},
        )
    res = dc.dist_exact_loglik(
        x["dists"], x["z_accept"], params(), nugget=NUGGET, panel=EXACT_PANEL,
        mesh=mesh, device="cpu",
    )
    out["exact"] = dict(loglik=res.loglik, logdet=res.logdet, quad=res.quad)
    return out


def case_permuted(x, carried) -> dict:
    """The same ranks on a (2, 2) mesh named ("model", "data"): the pair
    axis ("data", "model") then orders the shards as ranks 0, 2, 1, 3, not
    as the ranks, and every gather must put the parts in shard order."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distribution.block_cyclic import pair_shard

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("model", "data"))
    out = dict(shard=pair_shard(mesh).index, ranks=pair_shard(mesh).ranks)
    out.update(case_batches(mesh, x))
    out["cholesky"] = case_cholesky(mesh, carried, forms=("masked",))
    out["loglik"] = case_loglik(
        mesh, x, carried, forms=("masked", "block_cyclic"), from_grid=False
    )
    out["exact"] = case_exact(mesh, x)
    return out


def run_all(mesh, carried) -> dict:
    """Every case once on ``mesh``; ``carried`` is the reference's compressed
    grid matrix (diag, u, v, ranks) of the small geometry."""
    x = inputs()
    out = {} if mesh is None else dict(meshes=case_meshes(mesh))
    out.update(case_batches(mesh, x))
    out.update(case_compress(mesh, x))
    out["cholesky"] = case_cholesky(mesh, carried)
    out["loglik"] = case_loglik(mesh, x, carried)
    out["exact"] = case_exact(mesh, x)
    out["serve"] = case_serve(mesh, x)
    out["faults"] = case_faults(mesh, x)
    if mesh is not None and tuple(mesh.mesh.shape) == (2, 2):
        out["permuted"] = case_permuted(x, carried)
        out["pod"] = case_pod(x)
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits in an all_reduce."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_reduce_

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    all_reduce_(torch.ones(1))

"""The port's multi-device geostatistics forms on a torch.distributed mesh
(repro_torch.launch.mesh, distribution/, core/dist_tlr.py,
core/dist_cholesky.py, serving/cokrige_service.py) on the CPU over gloo.

Two spawns, W = 4 ranks on a (2, 2) ("data", "model") mesh and W = 3 on
(3, 1), for the padding of a pair count the ranks do not divide; each runs
every case of tests/torch_mesh_ranks.py once, and the tests below assert on
every rank's results.  The reference's own mesh forms do not run under this
JAX (a ShardingTypeError inside its shard_map; ROADMAP Queue 3), and by its
contract they compute what its mesh=None forms compute: so each case is
held against the reference's mesh=None form at the tolerance of the
matching test_torch_dist_*.py test (1e-10 on solves, 1e-9 on logliks), and
against the port's own mesh=None form at 1e-12 with equal factor ranks.
The Cholesky forms are held against the reference's single-level masked
form (test_torch_dist_tlr.py holds each of the port's forms against the
reference's same form, and all of them against that one)."""

import concurrent.futures
import math
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.core import covariance as jc  # noqa: E402
from repro.core import dist_cholesky as jdc  # noqa: E402
from repro.core import dist_tlr as jd  # noqa: E402
from repro.core import tlr as jtlr  # noqa: E402
from repro.distribution import block_cyclic as jb  # noqa: E402
from repro.distribution import compress_svd as jcs  # noqa: E402
from repro.serving import cokrige_service as jsvc  # noqa: E402
from repro_torch.core.likelihood import exact_loglik  # noqa: E402
from repro_torch.core.recovery import sentinel_loglik  # noqa: E402
from repro_torch.distribution import block_cyclic as tb  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402

WORLDS = (4, 3)
SHAPES = {4: (2, 2), 3: (3, 1)}
# The reference and the port factor the same matrix in another order of
# sums: serving outputs agree to this relative to their largest magnitude
# (tests/test_torch_serving.py's PARITY).
PARITY = 1e-8
OWN = 1e-12  # the mesh forms against the port's own mesh=None forms
TIGHT = dict(rtol=1e-10, atol=1e-10)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _carried(x):
    """The reference's TLR compression of the small geometry's dense Sigma
    (test_torch_dist_tlr.py's grid_case): tile 48, tol 1e-9, max rank 48."""
    jp = jc.MaternParams.bivariate(**R.PARAMS)
    sigma = jc.build_sigma(jnp.asarray(x["small"]), jp, nugget=R.NUGGET)
    jt = jax.jit(partial(jtlr.tlr_compress, tile_size=48, tol=1e-9, max_rank=48))(sigma)
    return jt, tuple(np.asarray(a) for a in jt)


def _jax_references(x, jt):
    jp = jc.MaternParams.bivariate(**R.PARAMS)
    out = {}
    parts = [jnp.asarray(a) for a in x["recompress"]]
    un, vn, rn, bad = jax.jit(jtlr._batched_recompress_stat, static_argnums=(4, 5))(
        *parts, 1e-6, 1.0
    )
    out["recompress"] = dict(uv=R.products(un, vn), ranks=np.asarray(rn), bad=int(bad))
    U, V, Rk = jax.jit(jcs.svd_truncate_batch, static_argnums=(1, 2, 3))(
        jnp.asarray(x["tiles"]), 1e-7, 8, 1.0
    )
    out["svd"] = dict(uv=R.products(U, V), ranks=np.asarray(Rk))
    T = 2 * len(x["small"]) // R.SMALL["tile"]
    lay = jb.pair_layout(T, 1)
    compress = jax.jit(
        lambda locs: jd.dist_compress_tiles(
            locs, jp, tile_size=48, tol=1e-9, max_rank=48, nugget=R.NUGGET,
            gen="xla", layout=lay,
        )
    )
    t = compress(jnp.asarray(x["small"])).to_grid(lay)
    out["compress"] = dict(diag=np.asarray(t.diag), uv=R.products(t.u, t.v),
                           ranks=np.asarray(t.ranks))
    chol = partial(jd.dist_tlr_cholesky, tol=1e-11, scale=1.0, track_status=True)
    f = jax.jit(chol)(jt.diag, jt.u, jt.v, jt.ranks)
    out["cholesky"] = dict(diag=np.asarray(f[0]), uv=R.products(f[1], f[2]),
                           ranks=np.asarray(f[3]), min_pivot=float(f[4].min_pivot))
    run = jax.jit(
        lambda locs, zz: jd.dist_tlr_loglik(
            None, zz, locs=locs, params=jp, from_tiles=True, gen="xla", tile_size=48,
            max_rank=48, nugget=R.NUGGET, tol=1e-7,
        ).loglik
    )
    out["loglik"] = float(run(jnp.asarray(x["small"]), jnp.asarray(x["z_small"])))
    carried = jax.jit(partial(jd.dist_tlr_loglik, tol=1e-12, scale=1.0))
    out["loglik_from_grid"] = float(carried(jt, jnp.asarray(x["z_small"])).loglik)
    dists = jnp.asarray(x["dists"])
    res = jdc.dist_exact_loglik(dists, jnp.asarray(x["z_accept"]), jp,
                                nugget=R.NUGGET, panel=R.EXACT_PANEL)
    out["exact"] = {k: float(getattr(res, k)) for k in ("loglik", "logdet", "quad")}
    sigma = jax.jit(lambda d: jc.build_sigma(None, jp, dists=d, nugget=R.NUGGET))(dists)

    @jax.jit
    def solves(a, b):
        panels = jdc.blocked_cholesky_panels(a, R.EXACT_PANEL)
        return (jdc.panels_forward_solve(panels, b, R.EXACT_PANEL),
                jdc.panels_backward_solve(panels, b, R.EXACT_PANEL),
                jdc.blocked_cholesky(a, R.EXACT_PANEL))

    fw, bw, lo = solves(sigma, jnp.asarray(x["rhs"]))
    out["solves"] = {
        k: np.asarray(a) for k, a in (("forward", fw), ("backward", bw), ("chol", lo))
    }
    jcfg = jsvc.CokrigeServeConfig(tile_size=64, max_rank=24, tol=1e-7, nugget=R.NUGGET)
    fit, predict = jsvc.make_cokrige_serve_fns(jcfg)
    factor = fit(jnp.asarray(x["accept"]), jnp.asarray(x["z_accept"]), jp)
    pred = predict(factor, jnp.asarray(x["pred"]))
    out["serve"] = dict(
        alpha=np.asarray(factor.alpha),
        ranks=np.asarray(jb.pairs_to_grid(factor.ranks, jb.pair_layout(8, 1))),
    )
    for f in ("mean", "variance", "lower", "upper"):
        out["serve"][f] = np.asarray(getattr(pred, f))
    return out


def _fake_dryrun():
    """R.DRYRUN's cells traced on a fake (2, 2) mesh (rank 0)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GeoStatShape
    from repro_torch.launch.dryrun import run_cell

    out = {}
    for key, arch, shape in R.DRYRUN:
        gs = GeoStatShape(*shape)
        out[key] = run_cell(arch, gs.name, "pod", out_dir=None, device="cpu",
                            world=(2, 2), cfg=get_arch(arch).reduced(), shape=gs,
                            correct_costs=False)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both spawns run while the references are computed here; the port's
    mesh=None results come from the same rank bodies with mesh=None."""
    x = R.inputs()
    jt, carried = _carried(x)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        spawn = partial(
            lm.spawn_ranks, R.run_all, args=(carried,), device_type="cpu",
            timeout_s=300.0,
        )
        futures = {w: pool.submit(spawn, w) for w in WORLDS}
        ref = _jax_references(x, jt)
        ref["dryrun"] = _fake_dryrun()
        own = R.run_all(None, carried)
        ranks = {w: f.result() for w, f in futures.items()}
    return dict(x=x, ref=ref, own=own, ranks=ranks)


def _each(runs, w):
    return runs["ranks"][w]


@pytest.mark.parametrize("w", WORLDS)
def test_launcher_builds_the_reference_mesh_shape_and_a_pod_axis(runs, w):
    """Every rank sees the mesh the reference's shape rule gives, at its own
    coordinate; a "pod" axis that row_axes leave out holds copies of one
    shard (the reference replicates over it), and splits the pairs when
    row_axes include it."""
    assert lm.mesh_shape_for(w) == SHAPES[w]
    coords = set()
    for r in _each(runs, w):
        m = r["meshes"]
        assert m["shape"] == SHAPES[w]
        coords.add(m["coordinate"])
        assert m["pod_outside_row_axes"] == 1
        assert m["pod_copy_primary"] == (m["rank"] == 0)  # pod coordinate 0
        assert m["pod_in_row_axes"] == w
    assert len(coords) == w


@pytest.mark.parametrize("rows", ["data", "pod_data"])
@pytest.mark.parametrize("form", ["loglik", "serve"])
def test_pod_mesh_forms_match_jax(runs, form, rows):
    """The block-cyclic TLR loglik and serving on the W = 4 spawn's (2, 1, 2)
    ("pod", "data", "model") mesh, with row_axes ("data",) (two pair shards,
    each held by both pods) and ("pod", "data") (four shards): the
    reference's mesh=None loglik to 1e-9 and serving outputs to PARITY, the
    port's mesh=None forms to 1e-12, the same on every rank."""
    ref, own = runs["ref"], runs["own"]
    for r in _each(runs, 4):
        got = r["pod"][f"{form}_{rows}"]
        assert got["status"]["ok"]
        if form == "loglik":
            assert got["shards"] == (2 if rows == "data" else 4)
            assert float(got["loglik"]) == pytest.approx(ref["loglik"], rel=1e-9)
            want = own["loglik"]["block_cyclic"]
            for field in ("loglik", "logdet", "quad"):
                assert float(got[field]) == pytest.approx(float(want[field]), rel=OWN)
            continue
        assert _rel(got["alpha"], ref["serve"]["alpha"]) <= PARITY
        assert _rel(got["alpha"], own["serve"]["alpha"]) <= OWN
        for field in ("mean", "variance", "lower", "upper"):
            assert _rel(got[field], ref["serve"][field]) <= PARITY, field
            assert _rel(got[field], own["serve"][field]) <= OWN, field


def test_pod_mesh_exact_form_matches_jax(runs):
    """dist_exact_loglik on the (2, 1, 2) pod mesh, its pair axis ("data",
    "model") held by both pods: the reference's loglik to 1e-9, the port's
    mesh=None to 1e-12."""
    ref, own = runs["ref"]["exact"], runs["own"]["exact"]
    for r in _each(runs, 4):
        got = r["pod"]["exact"]
        assert float(got["loglik"]) == pytest.approx(ref["loglik"], rel=1e-9)
        for field in ("loglik", "logdet", "quad"):
            assert float(got[field]) == pytest.approx(float(own[field]), rel=OWN)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", ["recompress", "recompress_nopad", "svd"])
def test_sharded_batches_match_jax_and_the_unsharded_form(runs, w, case):
    """sharded_recompress and sharded_truncate_svd: each rank factorizes its
    block of the 10 (7) slots, padded to a multiple of W, and every rank gets
    the whole result; the non-finite count is summed once.  pad=False on an
    indivisible length runs the replicated batch with its one warning."""
    key = "recompress" if case.startswith("recompress") else "svd"
    ref, own = runs["ref"][key], runs["own"][case]
    for r in _each(runs, w):
        got = r[case]
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        np.testing.assert_allclose(got["uv"], ref["uv"], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got["uv"], own["uv"], rtol=OWN, atol=OWN)
        if case == "recompress":
            assert int(got["bad"]) == ref["bad"] == 0
        if case == "recompress_nopad":
            assert len(got["warned"]) == 1 and "pad=False" in got["warned"][0]


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", ["recompress_subset", "svd_subset"])
def test_sharded_batches_over_a_subset_of_the_mesh_axes(runs, w, case):
    """axes=("data",) shards the batch over "data" alone and replicates it
    over "model", as the reference's P(axes) does: the whole result of the
    port's mesh=None form on every rank, and a NaN slot's non-finite count
    summed once, not once a copy."""
    own = runs["own"][case]
    for r in _each(runs, w):
        got = r[case]
        np.testing.assert_array_equal(got["ranks"], own["ranks"])
        np.testing.assert_allclose(got["uv"], own["uv"], rtol=OWN, atol=OWN)
        if case == "recompress_subset":
            assert int(got["bad"]) == int(own["bad"]) > 0


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("placement", ["compress_pairs", "compress_grid"])
def test_compress_matches_jax_in_both_placements(runs, w, placement):
    """Owned-slot generator-direct compression: each rank generates and
    SVDs exactly its own pair tiles (pairs_per_shard slots, their valid
    tiles summing to T(T-1)/2 over the ranks); the gathered pairs and the
    grid form give the reference's ranks and U V^T."""
    ref, own = runs["ref"]["compress"], runs["own"][placement]
    T = ref["ranks"].shape[0]
    lay = tb.pair_layout(T, w)
    svd_tiles = 0
    for r in _each(runs, w):
        got = r[placement]
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        np.testing.assert_allclose(got["diag"], ref["diag"], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got["uv"], ref["uv"], rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(got["uv"], own["uv"], rtol=OWN, atol=1e-14)
        if placement == "compress_pairs":
            assert got["held"] == lay.pairs_per_shard
            pps, d = lay.pairs_per_shard, int(got["shard"])
            mine = lay.valid[d * pps : (d + 1) * pps]
            assert got["tiles_svd"] == int(mine.sum())
            svd_tiles += got["tiles_svd"]
    if placement == "compress_pairs":
        assert svd_tiles == T * (T - 1) // 2


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("form", list(R.CHOL_FORMS) + ["pairs"])
def test_cholesky_forms_match_jax_with_equal_ranks(runs, w, form):
    """dist_tlr_cholesky in each form (and dist_tlr_cholesky_pairs, whose
    output holds the rank's own slots) on the reference's compressed
    matrix: the reference's factor to test_distributed.py's 1e-7 with equal
    ranks, and the port's mesh=None factor to 1e-12.  The sharded forms
    split the recompressions over the ranks, each pair recompressed once;
    the replicated one recompresses every pair on every rank."""
    ref, own = runs["ref"]["cholesky"], runs["own"]["cholesky"][form]
    total = runs["own"]["cholesky"][form if form != "pairs" else "block_cyclic"]
    done = 0
    for r in _each(runs, w):
        got = r["cholesky"][form]
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        np.testing.assert_array_equal(got["ranks"], own["ranks"])
        np.testing.assert_allclose(got["diag"], ref["diag"], atol=1e-7)
        np.testing.assert_allclose(got["uv"], ref["uv"], atol=1e-7)
        np.testing.assert_allclose(got["diag"], own["diag"], rtol=OWN, atol=1e-14)
        np.testing.assert_allclose(got["uv"], own["uv"], rtol=OWN, atol=1e-14)
        assert got["status"] == own["status"] and got["status"]["ok"]
        assert got["status"]["min_pivot"] == pytest.approx(ref["min_pivot"], rel=1e-12)
        if form == "pairs":
            T = ref["ranks"].shape[0]
            assert got["held"] == tb.pair_layout(T, w).pairs_per_shard
        elif form == "block_cyclic_replicated":
            assert got["pairs_recompressed"] == total["pairs_recompressed"]
        else:
            assert 0 < got["pairs_recompressed"] < total["pairs_recompressed"]
            done += got["pairs_recompressed"]
    if form not in ("pairs", "block_cyclic_replicated"):
        assert done == total["pairs_recompressed"]


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("form", list(R.LOGLIK_FORMS) + ["from_grid", "from_grid_bc"])
def test_dist_tlr_loglik_matches_jax(runs, w, form):
    """dist_tlr_loglik, streaming (from_tiles) in each form and from the
    reference's compressed matrix in both placements: the reference's loglik
    to 1e-9 (1e-10 from the carried matrix; mixed_f32 to the dist phase's
    1e-5 of the f64 one, test_torch_precision.py holding it against the
    reference's policy), the port's mesh=None to 1e-12, whole on every rank
    with the same status."""
    own = runs["own"]["loglik"][form]
    want = runs["ref"]["loglik_from_grid" if form.startswith("from") else "loglik"]
    rel = {"from_grid": 1e-10, "from_grid_bc": 1e-10, "mixed_f32": 1e-5}.get(form, 1e-9)
    for r in _each(runs, w):
        got = r["loglik"][form]
        assert float(got["loglik"]) == pytest.approx(want, rel=rel)
        for field in ("loglik", "logdet", "quad"):
            assert float(got[field]) == pytest.approx(float(own[field]), rel=OWN)
        assert got["status"] == own["status"] and got["status"]["ok"]


@pytest.mark.parametrize("w", WORLDS)
def test_dist_exact_loglik_and_both_solves_match_jax(runs, w):
    """The exact panel Cholesky at the reference's acceptance geometry
    (m = 512, panel 64): the loglik to 1e-9, the forward and backward panel
    solves (one and three right-hand sides) and the assembled factor to
    1e-10 of the reference's, and to 1e-12 of the port's mesh=None."""
    ref, own = runs["ref"], runs["own"]["exact"]
    for r in _each(runs, w):
        got = r["exact"]
        assert float(got["loglik"]) == pytest.approx(ref["exact"]["loglik"], rel=1e-9)
        for field in ("loglik", "logdet", "quad"):
            assert float(got[field]) == pytest.approx(float(own[field]), rel=OWN)
        for name in ("forward", "backward", "chol"):
            np.testing.assert_allclose(got[name], ref["solves"][name], **TIGHT)
            np.testing.assert_allclose(got[name], own[name], rtol=OWN, atol=1e-13)
        np.testing.assert_allclose(
            got["forward1"], got["forward"][:, 0], rtol=OWN, atol=1e-13
        )


@pytest.mark.parametrize("w", WORLDS)
def test_exact_form_deals_block_rows_cyclically_without_redistribution(runs, w):
    """A difference by design (ROADMAP Queue 3): the reference keeps the
    trail GSPMD-sharded P(row, "model") and re-splits it every step; the
    port deals the panel-row blocks once, block i to rank i mod W.  Each
    rank generates only its own block rows of Sigma and keeps only its own
    rows of each panel."""
    nk = 2 * len(runs["x"]["accept"]) // R.EXACT_PANEL
    seen = []
    for d, r in enumerate(_each(runs, w)):
        mine = list(range(d, nk, w))
        assert r["exact"]["rows_built"] == mine
        held = [len([i for i in mine if i > k]) * R.EXACT_PANEL for k in range(nk - 1)]
        assert r["exact"]["held_rows"] == held + [0]
        seen += mine
    assert sorted(seen) == list(range(nk))


@pytest.mark.parametrize("w", WORLDS)
def test_serving_fit_and_predict_match_jax(runs, w):
    """fit_factor and predict_batch on the mesh at m = 512 (the reference's
    acceptance case): the factor holds the rank's own slots, its ranks and
    alpha are the reference's, and every rank serves the reference's means,
    variances and bounds (PARITY) and the port's mesh=None ones (1e-12);
    the bound serve functions and conditional draws run too."""
    ref, own = runs["ref"]["serve"], runs["own"]["serve"]
    T = ref["ranks"].shape[0]
    for r in _each(runs, w):
        got = r["serve"]
        assert got["status"]["ok"]
        assert got["held"] == tb.pair_layout(T, w).pairs_per_shard
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        assert _rel(got["alpha"], ref["alpha"]) <= PARITY
        assert _rel(got["alpha"], own["alpha"]) <= OWN
        for field in ("mean", "variance", "lower", "upper"):
            assert _rel(got[field], ref[field]) <= PARITY, field
            assert _rel(got[field], own[field]) <= OWN, field
        np.testing.assert_array_equal(got["again_mean"], got["mean"])
        assert got["draws"].shape == (4,) + got["mean"].shape
        assert np.all(np.isfinite(got["draws"]))
        np.testing.assert_allclose(got["draws"], own["draws"], rtol=OWN, atol=1e-14)


@pytest.mark.parametrize("w", WORLDS)
def test_fault_acceptance_on_the_mesh(runs, w):
    """The reference's 8-device acceptance on the mesh (m = 512, four
    colliding sensors): the breakdown is detected with a finite sentinel,
    the jitter ladder recovers on its second attempt within 1e-3 of the
    dense loglik at that jitter, and serving refuses a factor broken by an
    injected non-PSD tile; a NaN slot injected into the sharded compression
    is counted as on one device."""
    x, own = runs["x"], runs["own"]["faults"]
    for r in _each(runs, w):
        got = r["faults"]
        b = got["broken"]
        assert b["status"]["ok"] is False
        assert float(b["loglik"]) == sentinel_loglik(torch.float64)
        assert all(math.isfinite(float(b[k])) for k in ("loglik", "logdet", "quad"))
        assert b["status"] == own["broken"]["status"]
        lad = got["ladder"]
        assert bool(lad["ok"]) and int(lad["attempts"]) == 2
        dense = exact_loglik(
            x["dup"], x["z_dup"], R.params(), nugget=float(lad["jitter"]), device="cpu"
        )
        assert _rel(float(lad["loglik"]), float(dense.loglik)) < 1e-3
        assert got["fit_status"]["ok"] is False
        assert got["refused"]["code"] == "broken_factor"
        assert got["refused"]["status"]["ok"] is False
        assert got["nan_panel"]["status"]["nonfinite_count"] > 0
        assert got["nan_panel"]["status"] == _nan_panel_one_device(runs, w)


def _nan_panel_one_device(runs, w):
    """The port's mesh=None evaluation with the same NaN slot of the same
    layout (built for W shards)."""
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.testing import nan_compress_panel

    x = runs["x"]
    T = 2 * len(x["small"]) // R.SMALL["tile"]
    with nan_compress_panel(R.NAN_SLOT):
        res = dist_tlr_loglik(
            None, x["z_small"], locs=x["small"], params=R.params(), from_tiles=True,
            tile_size=R.SMALL["tile"], max_rank=48, nugget=R.NUGGET, gen="plain",
            block_cyclic=True, layout=tb.pair_layout(T, w), device="cpu",
        )
    return res.status.as_dict()


PERMUTED = (
    "recompress", "svd", "recompress_subset", "cholesky_masked", "cholesky_pairs",
    "loglik_masked", "loglik_block_cyclic", "exact",
)
VALUES = ("diag", "uv", "loglik", "logdet", "quad", "forward", "forward1",
          "backward", "chol")


@pytest.mark.parametrize("case", PERMUTED)
def test_a_mesh_in_another_dim_order_gives_the_same_results(runs, case):
    """The four ranks on a (2, 2) mesh named ("model", "data"): their shard
    indices follow the pair axis ("data", "model"), not the ranks, and every
    form still gives the port's mesh=None results, so each gather puts the
    shards' parts in shard order."""
    ranks = _each(runs, 4)
    assert [r["permuted"]["shard"] for r in ranks] == [0, 2, 1, 3]
    assert all(tuple(r["permuted"]["ranks"]) == (0, 2, 1, 3) for r in ranks)
    group, _, form = case.partition("_")
    if group in ("cholesky", "loglik"):
        own = runs["own"][group][form]
        got = [r["permuted"][group][form] for r in ranks]
    else:
        own, got = runs["own"][case], [r["permuted"][case] for r in ranks]
    for g in got:
        for key in set(own) & {"ranks", "bad"}:
            np.testing.assert_array_equal(g[key], own[key], err_msg=key)
        assert g.get("status") == own.get("status")
        for key in set(own) & set(VALUES):
            np.testing.assert_allclose(g[key], own[key], rtol=OWN, atol=1e-13)


@pytest.mark.parametrize("T,S", [(6, 4), (8, 3), (16, 4), (5, 8)])
def test_static_pair_tables_equal_jax(T, S):
    """column_owner_tables, owned_pair_tables and slice_positions: numpy
    copies of the reference's, equal entry for entry (sentinels included)."""
    lt, lj = tb.pair_layout(T, S), jb.pair_layout(T, S)
    for fn in ("column_owner_tables", "owned_pair_tables"):
        got, want = getattr(tb, fn)(lt), getattr(jb, fn)(lj)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    inner_t, inner_j = tb.pair_layout(T - 2, S), jb.pair_layout(T - 2, S)
    np.testing.assert_array_equal(
        tb.slice_positions(lt, inner_t, 2), jb.slice_positions(lj, inner_j, 2)
    )


def test_spawned_ranks_fail_fast_and_report_the_rank():
    """A rank that raises fails the spawn with its traceback, while the
    others wait in a collective: no hang, no caught failure."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        lm.spawn_ranks(R.fail_on_rank_one, 2, device_type="cpu", timeout_s=60.0)


def test_the_launchers_take_the_card_unless_the_cpu_is_named(tmp_path, monkeypatch):
    """make_mesh_for_devices, make_production_mesh and spawn_ranks run on
    CUDA by default: without a CUDA device each raises, naming the CPU
    option, before it builds or starts anything; device_type="cpu" builds
    the mesh on the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        lm.spawn_ranks(R.fail_on_rank_one, 2)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            lm.make_mesh_for_devices()
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            lm.make_production_mesh(multi_pod=True)
        mesh = lm.make_mesh_for_devices(device_type="cpu")
        assert mesh.device_type == "cpu" and tuple(mesh.mesh_dim_names) == lm.AXES
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key", [k for k, _, _ in R.DRYRUN])
def test_dry_run_collectives_equal_a_real_four_rank_run(runs, key):
    """The dry-run's fake 4-rank trace of a reduced geostat cell counts the
    bytes and calls of each collective, by kind and by mesh axis, and the
    FLOPs, that rank 0 of the real gloo spawn counts running the same
    cell."""
    fake = runs["ref"]["dryrun"][key]
    real = _each(runs, 4)[0]["dryrun"][key]
    assert fake["collectives"] == real["collectives"]
    assert fake["collectives"]["by_kind"]
    assert fake["hlo_flops_per_chip"] == real["flops"]

"""The port's pair-major TLR path (repro_torch.core.dist_tlr and
repro_torch.distribution) against the JAX reference on the CPU in float64:
the pair layout and its converters, the pair compression (ranks and U V^T
products, never U or V alone: SVD signs are free), the strict-lower-only
SVD against the reference's masked column batch, the pair Cholesky of the
very PairTLR the reference compressed, and the single- and multi-RHS pair
solves."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import dist_tlr as jd  # noqa: E402
from repro.core import tlr as jtlr  # noqa: E402
from repro.distribution import block_cyclic as jb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import dist_tlr as td  # noqa: E402
from repro_torch.core.likelihood import exact_loglik  # noqa: E402
from repro_torch.core.recovery import sentinel_loglik  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.distribution import block_cyclic as tb  # noqa: E402
from repro_torch.distribution.compress_svd import svd_truncate_batch  # noqa: E402
from repro_torch.distribution.pair_qr import sharded_recompress  # noqa: E402

NB, TOL, NUGGET = 32, 1e-10, 1e-8
PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)


@pytest.fixture(scope="module")
def case():
    """test_serving_cokrige.py's pair-solve case: 64 Morton-ordered
    locations, bivariate (m = 128, T = 4), tile 32, full rank allowed, and
    the reference's PairTLR and pair factor of it."""
    locs = grid_locations(8, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    T = 2 * len(locs) // NB
    jlay = jb.pair_layout(T, 1)
    scale = 1.0 + NUGGET

    @jax.jit
    def compress_and_factor(x):
        t = jd.dist_compress_tiles(
            x, jp, tile_size=NB, tol=TOL, max_rank=NB, nugget=NUGGET, scale=scale,
            layout=jlay, gen="pallas",
        )
        f = jd.dist_tlr_cholesky_pairs(
            t.diag, t.u, t.v, t.ranks, layout=jlay, tol=TOL, scale=scale,
            track_status=True,
        )
        return t, f

    jt, jf = compress_and_factor(jnp.asarray(locs))
    return dict(locs=locs, tp=tp, T=T, scale=scale, jt=jt, jf=jf, jlay=jlay)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _products(u, v):
    """(length, nb, nb) U V^T of every slot, as numpy."""
    return np.einsum("lnk,lmk->lnm", np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("T,S", [(1, 1), (2, 1), (5, 1), (8, 1), (7, 3), (16, 8)])
def test_pair_layout_equals_jax(T, S):
    got, want = tb.pair_layout(T, S), jb.pair_layout(T, S)
    assert (got.n_tiles, got.n_shards, got.pairs_per_shard) == (
        want.n_tiles,
        want.n_shards,
        want.pairs_per_shard,
    )
    assert (got.length, got.n_pairs) == (want.length, want.n_pairs)
    for name in ("il", "jl", "pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if S == 1:
        # one shard: a column's pairs, and the pairs right of a column, are
        # consecutive slots, so the port reads them as views
        for k in range(T - 1):
            assert isinstance(tt.index_of(got.pos[k + 1 :, k], "cpu"), slice)


@pytest.mark.parametrize("T,S", [(5, 1), (6, 4)])
def test_grid_pairs_round_trip_equals_jax(T, S):
    rng = np.random.default_rng(T)
    grid = rng.normal(size=(T, T, 3, 2)) * np.tril(np.ones((T, T)), -1)[..., None, None]
    lay_t, lay_j = tb.pair_layout(T, S), jb.pair_layout(T, S)
    pairs = tb.grid_to_pairs(_t(grid), lay_t)
    want = jb.grid_to_pairs(grid, lay_j)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want))
    back = tb.pairs_to_grid(pairs, lay_t)
    want = jb.pairs_to_grid(pairs.numpy(), lay_j)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_array_equal(back.numpy(), grid)


def test_pair_compress_matches_jax(case):
    lay = tb.pair_layout(case["T"], 1)
    got = td.dist_compress_tiles(
        case["locs"], case["tp"], tile_size=NB, tol=TOL, max_rank=NB, nugget=NUGGET,
        scale=case["scale"], layout=lay, gen="kernel", device="cpu",
    )
    want = case["jt"]
    assert isinstance(got, td.PairTLR) and got.n_shards == want.n_shards == 1
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    _close(got.diag, want.diag, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        _products(got.u, got.v), _products(want.u, want.v), rtol=1e-9, atol=1e-11
    )


def test_strict_lower_svd_gives_the_masked_column_batch(case):
    """The reference SVDs all T tiles of a column panel and masks rows
    i <= j; the port SVDs the strict-lower tiles only.  Same values."""
    lay, T = tb.pair_layout(case["T"], 1), case["T"]
    got = td.dist_compress_tiles(
        case["locs"], case["tp"], tile_size=NB, tol=TOL, max_rank=NB, nugget=NUGGET,
        scale=case["scale"], layout=lay, device="cpu",
    )
    locs = torch.as_tensor(case["locs"])
    nbl = NB // 2
    for j in range(T - 1):
        panel = tc.build_sigma_column(locs, j, nbl, case["tp"])  # (m, nb)
        tiles = panel.reshape(T, NB, NB)
        U, V, R = svd_truncate_batch(tiles, TOL, NB, case["scale"])
        below = torch.arange(T) > j
        U, V, R = U[below], V[below], R[below]  # the reference's mask
        slots = lay.pos[j + 1 :, j]
        np.testing.assert_array_equal(got.ranks[slots].numpy(), R.numpy())
        uv = _products(got.u[slots], got.v[slots])
        _close(uv, _products(U, V), rtol=1e-12, atol=1e-14)
        _close(got.diag[j], tiles[j].numpy() + NUGGET * np.eye(NB))


def test_pair_cholesky_of_the_carried_matrix_matches_jax(case):
    jt, jf = case["jt"], case["jf"]
    lay = tb.pair_layout(case["T"], 1)
    inputs = (_t(jt.diag), _t(jt.u), _t(jt.v), _t(jt.ranks, torch.int32))
    diag, u, v, ranks, status = td.dist_tlr_cholesky_pairs(
        *inputs, layout=lay, tol=TOL, scale=case["scale"], track_status=True
    )
    assert status.as_dict()["ok"] and bool(jf[4].ok)
    _close(float(status.min_pivot), float(jf[4].min_pivot), rtol=1e-12)
    _close(diag, jf[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jf[3]))
    np.testing.assert_allclose(
        _products(u, v), _products(jf[1], jf[2]), rtol=1e-9, atol=1e-11
    )
    # the inputs are not modified
    for got, want in zip(inputs, (jt.diag, jt.u, jt.v, jt.ranks)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pair_cholesky_equals_the_grid_form(case):
    """The pair body and slice 1's grid body share the GEMM + recompress
    helper; on the same matrix they give the same factor."""
    jt = case["jt"]
    lay = tb.pair_layout(case["T"], 1)
    pairs = td.PairTLR(_t(jt.diag), _t(jt.u), _t(jt.v), _t(jt.ranks, torch.int32))
    args = (pairs.diag, pairs.u, pairs.v, pairs.ranks)
    got = td.dist_tlr_cholesky_pairs(*args, layout=lay, tol=TOL, scale=case["scale"])
    grid = tt.tlr_cholesky(pairs.to_grid(lay), tol=TOL, scale=case["scale"])
    _close(got[0], grid.diag, rtol=1e-12, atol=1e-14)
    ranks = tb.pairs_to_grid(got[3], lay)
    np.testing.assert_array_equal(ranks.numpy(), grid.ranks.numpy())
    u, v = (tb.pairs_to_grid(x, lay).flatten(0, 1) for x in got[1:3])
    uv = _products(grid.u.flatten(0, 1), grid.v.flatten(0, 1))
    _close(_products(u, v), uv, rtol=1e-11, atol=1e-13)


def _dense_lower(diag, u, v, lay, nb):
    T = diag.shape[0]
    lo = np.zeros((T * nb, T * nb))
    for i in range(T):
        lo[i * nb : (i + 1) * nb, i * nb : (i + 1) * nb] = np.tril(diag[i])
    for q in np.nonzero(lay.valid)[0]:
        i, j = int(lay.il[q]), int(lay.jl[q])
        lo[i * nb : (i + 1) * nb, j * nb : (j + 1) * nb] = u[q] @ v[q].T
    return lo


def test_pair_solves_match_jax_and_invert_the_factor(case):
    jf, jlay = case["jf"], case["jlay"]
    lay = tb.pair_layout(case["T"], 1)
    diag, u, v = (_t(x) for x in jf[:3])
    m = diag.shape[0] * NB
    b = np.random.default_rng(0).normal(size=(m, 3))
    lo = _dense_lower(diag.numpy(), u.numpy(), v.numpy(), lay, NB)

    w = td.dist_tlr_solve_lower_pairs(diag, u, v, _t(b), layout=lay)
    x = td.dist_tlr_solve_upper_pairs(diag, u, v, _t(b), layout=lay)
    np.testing.assert_allclose(lo @ w.numpy(), b, atol=1e-8)
    np.testing.assert_allclose(lo.T @ x.numpy(), b, atol=1e-8)

    solve_l = jax.jit(partial(jd.dist_tlr_solve_lower_pairs, layout=jlay))
    solve_u = jax.jit(partial(jd.dist_tlr_solve_upper_pairs, layout=jlay))
    for rhs in (b, b[:, 0]):
        wl = td.dist_tlr_solve_lower_pairs(diag, u, v, _t(rhs), layout=lay)
        xu = td.dist_tlr_solve_upper_pairs(diag, u, v, _t(rhs), layout=lay)
        assert wl.shape == xu.shape == rhs.shape
        want_l = np.asarray(solve_l(*jf[:3], jnp.asarray(rhs)))
        want_u = np.asarray(solve_u(*jf[:3], jnp.asarray(rhs)))
        np.testing.assert_allclose(wl.numpy(), want_l, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(xu.numpy(), want_u, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        td.dist_tlr_solve_lower_pairs(diag, u, v, _t(b[:, 0]), layout=lay).numpy(),
        w[:, 0].numpy(),
        atol=1e-12,
    )


def test_meshes_are_refused(case):
    """The port is single-device: a mesh raises instead of being ignored."""
    with pytest.raises(ValueError, match="mesh"):
        tb.pair_shards(object())
    assert tb.pair_shards(None) == 1
    jt = case["jt"]
    u, v = _t(jt.u), _t(jt.v)
    with pytest.raises(ValueError, match="mesh"):
        sharded_recompress(u, v, u, v, 1e-7, 1.0, mesh=object())


# ---------------------------------------------------------------------------
# The grid API, the super-panel forms and dist_tlr_loglik (test_distributed.py's
# single-device cases at its n = 144, T = 6 geometry)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid_case():
    """test_distributed.py::_setup: 144 Morton-ordered locations (m = 288),
    the dense Sigma compressed by the reference at tile 48 (T = 6), tol
    1e-9, max rank 48, and a data vector made with numpy."""
    locs = grid_locations(12, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    sigma = jc.build_sigma(jnp.asarray(locs), jp, nugget=NUGGET)
    jt = jax.jit(partial(jtlr.tlr_compress, tile_size=48, tol=1e-9, max_rank=48))(sigma)
    z = np.random.default_rng(2).normal(size=sigma.shape[0])
    return dict(locs=locs, jp=jp, tp=tp, jt=jt, z=z)


def _grid_products(u, v):
    return np.einsum("ijnk,ijmk->ijnm", np.asarray(u), np.asarray(v))


FORMS = {
    "masked": {},
    "super3": dict(super_panels=3),
    "block_cyclic": dict(block_cyclic=True),
    "block_cyclic_super3": dict(block_cyclic=True, super_panels=3),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_dist_tlr_cholesky_forms_match_jax(grid_case, form):
    """Each form of the grid API against the reference's same form
    (tests/test_distributed.py's tolerances: 1e-7 on the factored diagonal
    tiles and U V^T, ranks exactly), with the merged status."""
    kw = FORMS[form]
    jt = grid_case["jt"]
    kw = dict(tol=1e-11, scale=1.0, track_status=True, **kw)
    fn = jax.jit(partial(jd.dist_tlr_cholesky, **kw))
    want = fn(jt.diag, jt.u, jt.v, jt.ranks)
    inputs = (_t(jt.diag), _t(jt.u), _t(jt.v), _t(jt.ranks, torch.int32))
    got = td.dist_tlr_cholesky(*inputs, **kw)
    assert len(got) == len(want) == 5
    _close(got[0], want[0], atol=1e-7)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _close(_grid_products(got[1], got[2]), _grid_products(want[1], want[2]), atol=1e-7)
    assert got[4].as_dict()["ok"] and bool(want[4].ok)
    _close(float(got[4].min_pivot), float(want[4].min_pivot), rtol=1e-12)
    # every form gives the single-level masked factor
    plain = td.dist_tlr_cholesky(*inputs, tol=1e-11, scale=1.0)
    for a, b in zip(got[:4], plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dist_tlr_cholesky_defaults_and_refusals(grid_case):
    jt = grid_case["jt"]
    diag, u, v = _t(jt.diag), _t(jt.u), _t(jt.v)
    out = td.dist_tlr_cholesky(diag, u, v, tol=1e-11)  # ranks=None: zeros
    want = jd.dist_tlr_cholesky(jt.diag, jt.u, jt.v, tol=1e-11)
    assert len(out) == 4
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(want[3]))
    with pytest.raises(ValueError, match="super_panels=4 must divide n_tiles=6"):
        td.dist_tlr_cholesky(diag, u, v, super_panels=4)
    with pytest.raises(AssertionError):
        jd.dist_tlr_cholesky(jt.diag, jt.u, jt.v, super_panels=4)
    with pytest.raises(ValueError, match="mesh"):
        td.dist_tlr_cholesky(diag, u, v, mesh=object())


@pytest.mark.parametrize("entry", ["grid", "pairs"])
def test_dist_tlr_loglik_from_matrix_matches_jax(grid_case, entry):
    """dist_tlr_loglik(t, z) of the reference's compressed matrix: a
    TLRMatrix, or a PairTLR (which forces block_cyclic), and the dense
    exact loglik within test_distributed.py's 1e-6."""
    jt, z = grid_case["jt"], grid_case["z"]
    t = convert.tlr_matrix_from_numpy(*(np.asarray(x) for x in jt), device="cpu")
    jin = jt
    if entry == "pairs":
        jlay = jb.pair_layout(jt.n_tiles, 1)
        jin = jd.PairTLR(
            diag=jt.diag,
            u=jb.grid_to_pairs(jt.u, jlay),
            v=jb.grid_to_pairs(jt.v, jlay),
            ranks=jb.grid_to_pairs(jt.ranks, jlay),
        )
        arrays = (np.asarray(x) for x in (jin.diag, jin.u, jin.v, jin.ranks))
        t = convert.pair_tlr_from_numpy(*arrays, 1, device="cpu")
    run = jax.jit(partial(jd.dist_tlr_loglik, tol=1e-12, scale=1.0))
    want = run(jin, jnp.asarray(z))
    got = td.dist_tlr_loglik(t, z, tol=1e-12, scale=1.0)
    for field in ("loglik", "logdet", "quad"):
        assert float(getattr(got, field)) == pytest.approx(
            float(getattr(want, field)), rel=1e-10
        )
    assert got.status.as_dict()["ok"]
    want = exact_loglik(
        grid_case["locs"], z, grid_case["tp"], nugget=NUGGET, device="cpu"
    )
    assert float(got.loglik) == pytest.approx(float(want.loglik), rel=1e-6)


FROM_TILES = {
    "masked": {},
    "block_cyclic_super3_cb2": dict(block_cyclic=True, super_panels=3, col_block=2),
}


@pytest.mark.parametrize("form", list(FROM_TILES))
def test_dist_tlr_loglik_from_tiles_matches_jax(grid_case, form):
    """The streaming entry mode (locs, params, from_tiles=True; scale
    max(sigma2) + nugget) against the reference's, relative 1e-9."""
    kw = dict(tile_size=48, max_rank=48, nugget=NUGGET, tol=1e-7, **FROM_TILES[form])
    z = grid_case["z"]

    @jax.jit
    def run(x, zz):
        return jd.dist_tlr_loglik(
            None, zz, locs=x, params=grid_case["jp"], from_tiles=True, gen="xla", **kw
        ).loglik

    want = float(run(jnp.asarray(grid_case["locs"]), jnp.asarray(z)))
    got = td.dist_tlr_loglik(
        None, z, locs=grid_case["locs"], params=grid_case["tp"], from_tiles=True,
        gen="plain", device="cpu", **kw,
    )
    assert float(got.loglik) == pytest.approx(want, rel=1e-9)
    assert got.status.as_dict()["ok"]


def test_dist_tlr_loglik_layout_errors_as_in_jax(grid_case):
    """The two layout ValueErrors: a layout that does not cover the tile
    grid, and a PairTLR scattered for another shard count; and the entry
    without tiles or locations."""
    locs, z = grid_case["locs"], grid_case["z"]
    kw = dict(from_tiles=True, tile_size=48, block_cyclic=True)
    with pytest.raises(ValueError, match="layout covers n_tiles=5"):
        lay = tb.pair_layout(5, 1)
        td.dist_tlr_loglik(None, z, locs=locs, params=grid_case["tp"], layout=lay, **kw)
    with pytest.raises(ValueError, match="layout covers n_tiles=5"):
        lay = jb.pair_layout(5, 1)
        jd.dist_tlr_loglik(None, z, locs=locs, params=grid_case["jp"], layout=lay, **kw)
    jt = grid_case["jt"]
    t = convert.pair_tlr_from_numpy(
        np.asarray(jt.diag), np.zeros((15, 48, 48)), np.zeros((15, 48, 48)),
        np.zeros(15), 1, device="cpu",
    )
    jpair = jd.PairTLR(jt.diag, jnp.zeros((15, 48, 48)), jnp.zeros((15, 48, 48)),
                       jnp.zeros(15, jnp.int32), n_shards=1)
    with pytest.raises(ValueError, match="n_shards=1 but layout has n_shards=3"):
        td.dist_tlr_loglik(t, z, layout=tb.pair_layout(6, 3))
    with pytest.raises(ValueError, match="n_shards=1 but layout has n_shards=3"):
        jd.dist_tlr_loglik(jpair, z, layout=jb.pair_layout(6, 3))
    for fn in (td.dist_tlr_loglik, jd.dist_tlr_loglik):
        with pytest.raises(ValueError, match="from_tiles"):
            fn(None, z)


@pytest.mark.parametrize("block_cyclic", [False, True])
def test_dist_tlr_loglik_breakdown_gives_the_sentinel_as_jax(grid_case, block_cyclic):
    """A diagonal tile that is not positive definite: the status is not ok
    and the loglik is the finite sentinel (_loglik_of), as in the
    reference, in both placements."""
    jt, z = grid_case["jt"], grid_case["z"]
    bad = jt._replace(diag=jt.diag.at[2].set(-jnp.eye(jt.tile_size)))
    run = jax.jit(partial(jd.dist_tlr_loglik, tol=1e-12, block_cyclic=block_cyclic))
    want = run(bad, jnp.asarray(z))
    t = convert.tlr_matrix_from_numpy(*(np.asarray(x) for x in bad), device="cpu")
    got = td.dist_tlr_loglik(t, z, tol=1e-12, block_cyclic=block_cyclic)
    assert not got.status.as_dict()["ok"] and not bool(want.status.ok)
    assert float(got.loglik) == float(want.loglik) == sentinel_loglik(torch.float64)
    assert float(got.logdet) == float(got.quad) == 0.0

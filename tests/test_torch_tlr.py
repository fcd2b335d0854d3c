"""The port's TLR path (repro_torch.core.tlr) against the JAX reference
(repro.core.tlr), on the CPU in float64: compression, the factorization of
the very TLRMatrix the reference compressed, the active-pair panel step
against the reference's masked batch, breakdown, and the slice end to end:
tlr_loglik(from_tiles=True) against the reference's gen="pallas" path (its
Pallas kernel in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import tlr as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.recovery import sentinel_loglik  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402

NB, KMAX, TOL, NUGGET = 40, 16, 1e-7, 1e-8
PARAMS = dict(sigma11=1.0, sigma22=1.0, a=0.09, nu11=0.5, nu22=1.5, beta=0.5)
FIELDS = ("loglik", "logdet", "quad")


@pytest.fixture(scope="module")
def case():
    """n = 200 Morton-ordered locations, bivariate (m = 400, T = 10), the
    reference's compressed TLRMatrix and a data vector."""
    locs = grid_locations(20, 10, jitter=0.3, seed=0)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    z = np.random.default_rng(0).normal(size=2 * len(locs))

    # jit: one compile for all panel shapes (eager dispatch compiles each op
    # once per shape, several times slower here)
    @jax.jit
    def compress(x):
        return jt.tlr_compress_tiles(
            x, jp, tile_size=NB, tol=TOL, max_rank=KMAX, nugget=NUGGET, gen="pallas"
        )

    jmat = compress(jnp.asarray(locs))
    return dict(locs=locs, jp=jp, tp=tp, z=z, jmat=jmat)


def _carry(jmat):
    arrays = (np.asarray(x) for x in jmat)
    return convert.tlr_matrix_from_numpy(*arrays, device="cpu")


def _products(u, v):
    """(T, T, nb, nb) U V^T of every tile, as numpy."""
    return np.einsum("ijnk,ijmk->ijnm", np.asarray(u), np.asarray(v))


def _assert_fields(got, want, rtol):
    for field in FIELDS:
        g, w = float(getattr(got, field)), float(getattr(want, field))
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=field)


def test_compress_tiles_matches_jax(case):
    got = tt.tlr_compress_tiles(
        case["locs"],
        case["tp"],
        tile_size=NB,
        tol=TOL,
        max_rank=KMAX,
        nugget=NUGGET,
        gen="kernel",
        device="cpu",
    )
    want = case["jmat"]
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    np.testing.assert_allclose(
        got.diag.numpy(), np.asarray(want.diag), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        _products(got.u, got.v), _products(want.u, want.v), rtol=1e-10, atol=1e-10
    )
    np.testing.assert_allclose(
        tt.tlr_to_dense(got).numpy(),
        np.asarray(jt.tlr_to_dense(want)),
        rtol=1e-10,
        atol=1e-10,
    )


def test_cholesky_of_the_carried_matrix_matches_jax(case):
    jmat, z = case["jmat"], case["z"]
    scale = 1.0 + NUGGET
    want_c = jt.tlr_cholesky(jmat, tol=TOL, scale=scale, track_status=True)
    want = jt.tlr_loglik_from_matrix(jmat, jnp.asarray(z), tol=TOL, scale=scale)
    tmat = _carry(jmat)
    got_c = tt.tlr_cholesky(tmat, tol=TOL, scale=scale, track_status=True)
    got = tt.tlr_loglik_from_matrix(tmat, z, tol=TOL, scale=scale)
    np.testing.assert_array_equal(got_c.ranks.numpy(), np.asarray(want_c.ranks))
    np.testing.assert_allclose(
        got_c.diag.numpy(), np.asarray(want_c.diag), rtol=1e-9, atol=1e-12
    )
    _assert_fields(got, want, rtol=1e-9)
    g, w = got.status.as_dict(), want.status.as_dict()
    assert g["ok"] and w["ok"]
    assert g["nonfinite_count"] == w["nonfinite_count"]
    assert g["breakdown_count"] == w["breakdown_count"]
    np.testing.assert_allclose(g["min_pivot"], w["min_pivot"], rtol=1e-9)
    # the input is cloned, not factored in place
    np.testing.assert_array_equal(tmat.diag.numpy(), np.asarray(jmat.diag))
    alpha = tt.tlr_solve_lower(got_c, z).numpy()
    want_alpha = np.asarray(jt.tlr_solve_lower(want_c, jnp.asarray(z)))
    np.testing.assert_allclose(alpha, want_alpha, rtol=1e-9, atol=1e-9)


def test_active_pair_gather_matches_the_masked_batch(case):
    """Two panel steps: only pairs j > k are recompressed in the port, the
    reference recompresses all T(T-1)/2 and masks; values and ranks agree."""
    jmat = case["jmat"]
    il, jl = np.tril_indices(jmat.n_tiles, k=-1)
    jpairs = (jnp.asarray(il), jnp.asarray(jl))
    jcarry = tuple(jmat)
    tcarry = tuple(x.clone() for x in _carry(jmat))
    for k in range(2):
        jcarry = jt.tlr_panel_body(k, *jcarry, tol=TOL, scale=1.0, pairs=jpairs)
        tcarry = tt.tlr_panel_body(k, *tcarry, tol=TOL, scale=1.0, pairs=(il, jl))
    jd, ju, jv, jr = jcarry
    td, tu, tv, tr = tcarry
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        _products(tu, tv), _products(ju, jv), rtol=1e-9, atol=1e-10
    )
    # inactive pairs (j <= k) are untouched by the step that skips them
    np.testing.assert_array_equal(tu[5, 0].numpy(), np.asarray(ju[5, 0]))


def test_non_spd_input_gives_bad_status_and_the_sentinel(case):
    jmat, z = case["jmat"], case["z"]
    bad_diag = np.asarray(jmat.diag).copy()
    bad_diag[3] = -bad_diag[3]
    jbad = jmat._replace(diag=jnp.asarray(bad_diag))
    want = jt.tlr_loglik_from_matrix(jbad, jnp.asarray(z), tol=TOL)
    got = tt.tlr_loglik_from_matrix(_carry(jbad), z, tol=TOL)
    assert not bool(want.status.ok)
    assert not got.status.as_dict()["ok"]
    sentinel = sentinel_loglik(torch.float64)
    assert float(got.loglik) == float(want.loglik) == sentinel
    assert float(got.logdet) == 0.0 and float(got.quad) == 0.0
    assert got.status.as_dict()["breakdown_count"] >= 1


def test_slice_end_to_end_matches_jax(case, monkeypatch):
    """tlr_loglik(from_tiles=True): GEN -> compress -> factorize -> solve,
    never forming the dense Sigma, against the reference's gen="pallas"."""
    kw = dict(tol=TOL, max_rank=KMAX, tile_size=NB, nugget=NUGGET, from_tiles=True)

    @jax.jit
    def reference(x, z):
        return jt.tlr_loglik(None, z, case["jp"], locs=x, gen="pallas", **kw)

    want = reference(jnp.asarray(case["locs"]), jnp.asarray(case["z"]))

    def boom(*a, **k):
        raise AssertionError("dense build_sigma was called")

    monkeypatch.setattr(tt, "build_sigma", boom)
    monkeypatch.setattr(tc, "build_sigma", boom)
    times = {}
    got = tt.tlr_loglik(
        None,
        case["z"],
        case["tp"],
        locs=case["locs"],
        gen="kernel",
        device="cpu",
        times=times,
        **kw,
    )
    assert got.status.as_dict()["ok"] and bool(want.status.ok)
    _assert_fields(got, want, rtol=1e-9)
    assert set(times) == {"gen", "compress", "factorize", "solve"}


def test_dense_validation_path_and_matvec_match_jax():
    locs = grid_locations(6, jitter=0.2, seed=1)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    dists = np.asarray(jc.pairwise_distances(jnp.asarray(locs)))
    z = np.random.default_rng(2).normal(size=2 * len(locs))
    kw = dict(tol=1e-9, max_rank=12, tile_size=24, nugget=1e-6)
    want = jt.tlr_loglik(jnp.asarray(dists), jnp.asarray(z), jp, **kw)
    got = tt.tlr_loglik(dists, z, tp, device="cpu", **kw)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik), rtol=1e-9)
    sigma = np.asarray(jc.build_sigma(jnp.asarray(locs), jp, nugget=1e-6))
    kw = dict(tile_size=24, tol=1e-9, max_rank=12)
    jmat = jt.tlr_compress(jnp.asarray(sigma), **kw)
    tmat = tt.tlr_compress(torch.as_tensor(sigma.copy()), **kw)
    np.testing.assert_array_equal(tmat.ranks.numpy(), np.asarray(jmat.ranks))
    got = tt.tlr_matvec(tmat, z).numpy()
    want = np.asarray(jt.tlr_matvec(jmat, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("nb,k", [(32, 8), (12, 8)])  # 2k > nb: R is wide
def test_recompress_matches_jax(nb, k):
    rng = np.random.default_rng(5)
    u1, v1, u2, v2 = (rng.normal(size=(3, nb, k)) for _ in range(4))
    u1[..., k - 2 :] = 0.0  # padded rank columns
    v1[..., k - 2 :] = 0.0
    parts = (u1, v1, u2, v2)
    ju, jv, jr = jt.recompress(*(jnp.asarray(x) for x in parts), 1e-6, 1.0)
    tu, tv, tr = tt.recompress(*(torch.as_tensor(x) for x in parts), 1e-6, 1.0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    want = np.asarray(ju @ jnp.swapaxes(jv, -1, -2))
    np.testing.assert_allclose((tu @ tv.mT).numpy(), want, rtol=1e-9, atol=1e-9)


def test_reports_and_tile_size_match_jax(case):
    jmat = case["jmat"]
    tmat = _carry(jmat)
    assert tt.memory_footprint(tmat) == jt.memory_footprint(jmat)
    np.testing.assert_array_equal(
        tt.rank_distribution(tmat), jt.rank_distribution(jmat)
    )
    cases = [(400, 40, 2), (392, 40, 2), (1000, 0, 1), (32768, 512, 2), (98, 0, 7)]
    for m, target, mult in cases:
        want = jt.choose_tile_size(m, target, mult)
        assert tt.choose_tile_size(m, target, mult) == want
    with pytest.raises(ValueError):
        tt.choose_tile_size(9, 3, multiple_of=2)
    assert tt.tlr_mm_flops(512, 128) == jt.tlr_mm_flops(512, 128)

"""The port's dense likelihood, profile likelihood, simulation and breakdown
status against the JAX reference, on the CPU in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import likelihood as jl  # noqa: E402
from repro.core import recovery as jr  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import likelihood as tl  # noqa: E402
from repro_torch.core import recovery as tr  # noqa: E402
from repro_torch.core.simulate import grid_locations, simulate_mgrf  # noqa: E402

RTOL = 1e-10
PARAMS = dict(sigma11=1.0, sigma22=1.5, a=0.15, nu11=0.5, nu22=1.0, beta=0.4)


def _setup(n_side=7, seed=0):
    locs = grid_locations(n_side, jitter=0.2, seed=seed)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    z = np.random.default_rng(seed).normal(size=2 * len(locs))
    return locs, jp, tp, z


@pytest.mark.parametrize("representation", ["I", "II"])
def test_exact_loglik_matches_jax(representation):
    locs, jp, tp, z = _setup()
    kw = dict(representation=representation, nugget=1e-6)
    want = jl.exact_loglik(jnp.asarray(locs), jnp.asarray(z), jp, **kw)
    got = tl.exact_loglik(locs, z, tp, device="cpu", **kw)
    for field in ("loglik", "logdet", "quad"):
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)), rtol=RTOL
        )
    assert got.status.as_dict()["ok"] and bool(want.status.ok)
    np.testing.assert_allclose(
        float(got.status.min_pivot), float(want.status.min_pivot), rtol=RTOL
    )


def test_loglik_from_chol_matches_jax_and_keeps_the_factor():
    locs, jp, tp, z = _setup(5)
    sigma = np.asarray(jc.build_sigma(jnp.asarray(locs), jp, nugget=1e-6))
    chol = np.linalg.cholesky(sigma)
    want = jl.loglik_from_chol(jnp.asarray(chol), jnp.asarray(z), keep_chol=True)
    got = tl.loglik_from_chol(torch.as_tensor(chol), z, keep_chol=True)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik), rtol=RTOL)
    np.testing.assert_allclose(float(got.quad), float(want.quad), rtol=RTOL)
    np.testing.assert_array_equal(got.chol.numpy(), chol)


def test_profile_variances_and_loglik_match_jax():
    locs, jp, tp, z = _setup()
    dists = np.asarray(jc.pairwise_distances(jnp.asarray(locs)))
    nu = np.array([0.5, 1.0])
    for rep in ("I", "II"):
        kw = dict(nugget=1e-6, representation=rep)
        jargs = (jnp.asarray(dists), jnp.asarray(z), 0.15, jnp.asarray(nu), 2)
        want = jl.profile_variances(*jargs, **kw)
        got = tl.profile_variances(dists, z, 0.15, nu, 2, device="cpu", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    beta = np.array([[1.0, 0.4], [0.4, 1.0]])
    jargs = (jnp.asarray(x) for x in (locs, z, 0.15, nu, beta))
    want = jl.profile_loglik(*jargs, 2, nugget=1e-6)
    got = tl.profile_loglik(locs, z, 0.15, nu, beta, 2, nugget=1e-6, device="cpu")
    np.testing.assert_allclose(float(got.loglik), float(want.loglik), rtol=RTOL)


def test_simulate_mgrf_with_shared_draws_matches_jax():
    locs, jp, tp, _ = _setup(5)
    eps = np.random.default_rng(4).normal(size=(3, 2 * len(locs)))
    sigma = np.asarray(jc.build_sigma(jnp.asarray(locs), jp, nugget=1e-8))
    want = eps @ np.linalg.cholesky(sigma).T
    got = simulate_mgrf(None, locs, tp, nugget=1e-8, nsamples=3, eps=eps, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    draws = simulate_mgrf(g, locs, tp, nsamples=2, device="cpu")
    assert draws.shape == (2, 2 * len(locs))
    assert bool(torch.isfinite(draws).all())


def test_non_spd_sigma_gives_nan_factor_and_bad_status_as_in_jax():
    locs, jp, tp, z = _setup(5)
    locs = np.concatenate([locs, locs[:1]])  # a duplicated location
    z = np.concatenate([z, z[:2]])
    kw = dict(representation="I", nugget=None)
    want = jl.exact_loglik(jnp.asarray(locs), jnp.asarray(z), jp, **kw)
    got = tl.exact_loglik(locs, z, tp, device="cpu", **kw)
    assert not bool(want.status.ok)
    assert not got.status.as_dict()["ok"]
    assert np.isnan(float(got.loglik)) == np.isnan(float(want.loglik))


def test_status_algebra_and_sentinel_match_jax():
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        assert tr.sentinel_loglik(tdt) == float(jr.sentinel_loglik(jdt))
    lkk = np.array([[2.0, 0.0], [1.0, np.nan]])
    want = jr.init_status().update_potrf(jnp.asarray(lkk)).add_nonfinite(3)
    got = tr.init_status(device="cpu").update_potrf(torch.as_tensor(lkk))
    got = got.add_nonfinite(torch.tensor(3, dtype=torch.int32))
    assert got.as_dict() == want.as_dict()
    merged = got.merge(tr.init_status(device="cpu"))
    assert merged.as_dict() == got.as_dict()

"""The port's Matérn functions (repro_torch.core.matern) against the JAX
reference (repro.core.matern) and scipy, on the CPU in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.special as sps  # noqa: E402

from repro.core import matern as jm  # noqa: E402
from repro_torch.core import matern as tm  # noqa: E402

XS = np.concatenate(
    [
        np.geomspace(1e-8, 1.9, 30),
        np.array([1.999, 2.0, 2.001]),
        np.geomspace(2.1, 60.0, 30),
    ]
)
US = np.concatenate([[0.0], np.geomspace(1e-6, 30.0, 80)])


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("nu", [0.05, 0.3, 0.5, 0.73, 1.0, 1.5, 2.283, 3.7, 4.5, 6.0])
def test_kv_matches_jax_and_scipy(nu):
    got = tm.kv(nu, _t(XS)).numpy()
    want = np.asarray(jm.kv(nu, jnp.asarray(XS)))
    np.testing.assert_allclose(got, want, rtol=1e-11)
    np.testing.assert_allclose(got, sps.kv(nu, XS), rtol=5e-9)


def test_kv_half_integer_closed_forms():
    for nu in (0.5, 1.5, 2.5):
        got = tm.kv_half_integer(nu, _t(XS)).numpy()
        want = np.asarray(jm.kv_half_integer(nu, jnp.asarray(XS)))
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_correlation_halfint_matches_jax(nu):
    got = tm.matern_correlation_halfint(_t(US), nu).numpy()
    want = np.asarray(jm.matern_correlation_halfint(jnp.asarray(US), nu))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("nu", [0.5, 0.75, 1.0, 2.033, 2.5])
def test_matern_correlation_matches_jax(nu):
    got = tm.matern_correlation(_t(US), nu).numpy()
    want = np.asarray(jm.matern_correlation(jnp.asarray(US), nu))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_parsimonious_rho_and_nu_matrix_match_jax():
    nus = np.array([0.5, 1.2, 2.3])
    beta = np.array([[1.0, 0.4, -0.2], [0.4, 1.0, 0.3], [-0.2, 0.3, 1.0]])
    for d in (1, 2, 3):
        got = tm.parsimonious_rho(_t(nus), _t(beta), d=d).numpy()
        want = jm.parsimonious_rho(jnp.asarray(nus), jnp.asarray(beta), d=d)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    got = tm.parsimonious_nu_matrix(_t(nus)).numpy()
    want = np.asarray(jm.parsimonious_nu_matrix(nus))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_cross_covariance_matches_jax():
    h = np.geomspace(1e-4, 1.5, 40).reshape(8, 5)
    sig2 = np.array([1.0, 2.0])
    nus = np.array([0.5, 1.0])
    beta = np.array([[1.0, 0.6], [0.6, 1.0]])
    got = tm.cross_covariance(_t(h), _t(sig2), 0.2, _t(nus), _t(beta)).numpy()
    args = (jnp.asarray(x) for x in (h, sig2, 0.2, nus, beta))
    want = np.asarray(jm.cross_covariance(*args))
    assert got.shape == want.shape == (8, 5, 2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12)

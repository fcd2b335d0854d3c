"""The port's covariance assembly (repro_torch.core.covariance) against the
JAX reference (repro.core.covariance), on the CPU in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core.simulate import grid_locations as j_grid  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core.simulate import grid_locations, uniform_locations  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-14)
PARAMS = {
    "bivariate_general": dict(kind="bivariate", a=0.09, nu11=0.5, nu22=1.0, beta=0.5),
    # the chip's main cell: nu12 = 1.0, u up to about 47
    "bivariate_main": dict(kind="bivariate", a=0.03, nu11=0.5, nu22=1.5, beta=0.5),
    "bivariate_halfint": dict(
        kind="bivariate", a=0.12, nu11=0.5, nu22=2.5, beta=-0.3, sigma22=2.0
    ),
    "trivariate": dict(
        kind="trivariate",
        sigma2=(1.0, 0.5, 2.0),
        a=0.1,
        nu=(0.5, 1.0, 1.5),
        beta12=0.5,
        beta13=0.3,
        beta23=0.2,
    ),
}


def _params(name):
    kw = dict(PARAMS[name])
    kind = kw.pop("kind")
    jp = getattr(jc.MaternParams, kind)(**kw)
    tp = getattr(tc.MaternParams, kind)(**kw, device="cpu")
    return jp, tp


def _locs(n_side=6, seed=0):
    locs = grid_locations(n_side, jitter=0.2, seed=seed)
    return locs[tc.morton_order(locs)]


def test_morton_order_and_locations_equal_jax():
    for seed in range(3):
        locs = uniform_locations(300, seed=seed)
        np.testing.assert_array_equal(tc.morton_order(locs), jc.morton_order(locs))
    np.testing.assert_array_equal(
        grid_locations(7, 5, jitter=0.3, seed=2), j_grid(7, 5, jitter=0.3, seed=2)
    )


@pytest.mark.parametrize("representation", ["I", "II"])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_build_sigma_matches_jax(name, representation):
    jp, tp = _params(name)
    locs = _locs()
    want = jc.build_sigma(jnp.asarray(locs), jp, representation, nugget=1e-6)
    got = tc.build_sigma(locs, tp, representation, nugget=1e-6, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "name", ["bivariate_general", "bivariate_main", "bivariate_halfint"]
)
def test_build_sigma_panel_matches_jax_for_both_generators(name):
    """gen="kernel" / "plain" against the reference's "pallas" / "xla" on one
    ragged panel (rows and columns of different lengths)."""
    jp, tp = _params(name)
    locs = _locs()
    rows, cols = locs[4:], locs[:12]
    plain = tc.build_sigma_panel(rows, cols, tp, gen="plain", device="cpu")
    kernel = tc.build_sigma_panel(rows, cols, tp, gen="kernel", device="cpu")
    jrows, jcols = jnp.asarray(rows), jnp.asarray(cols)
    want_xla = jc.build_sigma_panel(jrows, jcols, jp, gen="xla")
    want_pallas = jc.build_sigma_panel(jrows, jcols, jp, gen="pallas", block=16)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_xla), **TOL)
    np.testing.assert_allclose(kernel.numpy(), np.asarray(want_pallas), **TOL)
    sigma = tc.build_sigma(locs, tp, device="cpu").numpy()
    np.testing.assert_allclose(plain.numpy(), sigma[8:, :24], **TOL)


def test_build_sigma_panel_rejects_unknown_generator():
    _, tp = _params("bivariate_general")
    with pytest.raises(ValueError, match="gen must be one of"):
        tc.build_sigma_panel(_locs(), _locs(), tp, gen="pallas", device="cpu")


def test_correlation_matrix_and_cross_cov_at_zero_match_jax():
    jp, tp = _params("trivariate")
    locs = _locs()
    got = tc.build_correlation_matrix(locs, 0.1, 1.3, nugget=1e-4, device="cpu")
    want = jc.build_correlation_matrix(jnp.asarray(locs), 0.1, 1.3, nugget=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tc.cross_cov_at_zero(tp).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.cross_cov_at_zero(jp)), **TOL)
    got = tc.pairwise_distances(torch.as_tensor(locs)).numpy()
    want = jc.pairwise_distances(jnp.asarray(locs))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_apply_ordering_places_locations():
    locs = _locs()
    perm = np.arange(len(locs))[::-1]
    got = tc.apply_ordering(locs, perm, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), locs[perm])

"""The port's MLOE/MMOM assessment (repro_torch.core.assessment, Algorithm 1)
and the deprecated chol= form of cokriging (repro_torch.core.prediction)
against the JAX reference on the CPU in float64: every function of the
assessment at rtol 1e-9, the reference's four MLOE/MMOM properties, and
test_cokrige_chol_threading's contract (Sigma never rebuilt, predictions
within 1e-9, a one-shot warning)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import assessment as ja  # noqa: E402
from repro.core import covariance as jc  # noqa: E402
from repro.core import prediction as jpred  # noqa: E402
from repro_torch.core import assessment as ta  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import prediction as tpred  # noqa: E402
from repro_torch.core.simulate import uniform_locations  # noqa: E402
from repro_torch.distribution import pair_qr  # noqa: E402

NUGGET = 1e-10
RTOL = 1e-9
PARAMS = dict(a=0.1, nu11=0.5, nu22=1.0, beta=0.8)
FIELDS = ("mloe", "mmom", "loe", "mom", "e_t", "e_ta", "e_a")


def _pair(a_scale=1.0, nu_scale=1.0, **kw):
    """The same bivariate theta in both packages, its range and
    smoothnesses scaled (the reference tests' misspecifications)."""
    args = dict(PARAMS, **kw)
    jp = jc.MaternParams.bivariate(**args)
    tp = tc.MaternParams.bivariate(**args, device="cpu")
    jp = jp._replace(a=jp.a * a_scale, nu=jp.nu * nu_scale)
    tp = tp._replace(a=tp.a * a_scale, nu=tp.nu * nu_scale)
    return jp, tp


@pytest.fixture(scope="module")
def case():
    """90 uniform observation locations (m = 180) and 8 prediction points,
    made with numpy, and the truth and a 1.5x range misspecification."""
    obs = uniform_locations(90, seed=0)
    pred = np.random.default_rng(4).uniform(0.05, 0.95, size=(8, 2))
    return dict(obs=obs, pred=pred, truth=_pair(), approx=_pair(a_scale=1.5))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def _ref_mloe(case, jt, ja_):
    fn = jax.jit(lambda o, p, t, a: ja.mloe_mmom(o, p, t, a, nugget=NUGGET))
    return fn(jnp.asarray(case["obs"]), jnp.asarray(case["pred"]), jt, ja_)


def test_gen_and_fact_match_jax(case):
    (jt, tt_), (ja_, ta_) = case["truth"], case["approx"]
    obs = case["obs"]
    want = ja.gen_matrices(jnp.asarray(obs), jt, ja_, nugget=NUGGET)
    got = ta.gen_matrices(obs, tt_, ta_, nugget=NUGGET, device="cpu")
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-12)
    lg = ta.fact_matrices(*got)
    lw = ja.fact_matrices(*want)
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-12)


def test_comp_and_mloe_mmom_match_jax(case):
    (jt, tt_), (ja_, ta_) = case["truth"], case["approx"]
    want = _ref_mloe(case, jt, ja_)
    times = {}
    got = ta.mloe_mmom(
        case["obs"], case["pred"], tt_, ta_, nugget=NUGGET, device="cpu", times=times
    )
    assert isinstance(got, ta.MloeMmomResult) and got._fields == want._fields
    for field in FIELDS:
        _close(getattr(got, field), getattr(want, field))
    assert sorted(times) == ["comp", "fact", "gen"]
    # COMP alone from the port's GEN and FACT
    obs, pred = case["obs"], case["pred"]
    sigma_t, sigma_a = ta.gen_matrices(obs, tt_, ta_, nugget=NUGGET, device="cpu")
    chol_t, chol_a = ta.fact_matrices(sigma_t, sigma_a)
    comp = ta.comp_criteria(obs, pred, tt_, ta_, sigma_t, chol_t, chol_a)
    for field in FIELDS:
        _close(getattr(comp, field), getattr(want, field))


def test_univariate_and_naive_match_jax(case):
    obs, pred = case["obs"], case["pred"]
    args = (1.0, 0.1, 0.5, 1.1, 0.13, 0.6)
    jobs, jpred_ = jnp.asarray(obs), jnp.asarray(pred)
    want = ja.mloe_mmom_univariate(jobs, jpred_, *args, nugget=NUGGET)
    got = ta.mloe_mmom_univariate(obs, pred, *args, nugget=NUGGET, device="cpu")
    for field in FIELDS:
        _close(getattr(got, field), getattr(want, field))
    (jt, tt_), (ja_, ta_) = case["truth"], case["approx"]
    want = ja.naive_multivariate_mloe_mmom(jobs, jpred_, jt, ja_, nugget=NUGGET)
    got = ta.naive_multivariate_mloe_mmom(obs, pred, tt_, ta_, nugget=NUGGET)
    for g, w in zip(got, want):
        _close(g, w)


def test_mloe_mmom_zero_at_truth(case):
    """theta_a == theta: E_ta == E_t == E_a, so MLOE = MMOM = 0."""
    tt_ = case["truth"][1]
    res = ta.mloe_mmom(case["obs"], case["pred"], tt_, tt_, nugget=NUGGET, device="cpu")
    assert float(res.mloe) == pytest.approx(0.0, abs=1e-8)
    assert float(res.mmom) == pytest.approx(0.0, abs=1e-8)


def test_mloe_nonnegative_and_grows_with_misspecification(case):
    """LOE >= 0 by the optimality of the true-parameter predictor."""
    tt_ = case["truth"][1]
    slight = _pair(a_scale=1.2)[1]
    severe = _pair(a_scale=3.0, nu_scale=0.6)[1]
    kw = dict(nugget=NUGGET, device="cpu")
    r1 = ta.mloe_mmom(case["obs"], case["pred"], tt_, slight, **kw)
    r2 = ta.mloe_mmom(case["obs"], case["pred"], tt_, severe, **kw)
    assert float(r1.mloe) >= -1e-9
    assert float(r2.mloe) > float(r1.mloe)
    assert bool((r1.e_t > 0).all())
    assert bool((r1.e_ta >= r1.e_t - 1e-9).all())


def test_univariate_criteria_are_the_p1_case():
    locs = uniform_locations(90, seed=3)
    pred = uniform_locations(8, seed=4)
    r = ta.mloe_mmom_univariate(
        locs, pred, 1.0, 0.1, 0.5, 1.1, 0.13, 0.6, nugget=NUGGET, device="cpu"
    )
    assert np.isfinite(float(r.mloe)) and np.isfinite(float(r.mmom))
    assert float(r.mloe) >= -1e-9


def test_naive_and_cokriging_criteria_differ(case):
    """The paper's §5.4 point: the naive per-variable extension ignores the
    cross-correlation, so it disagrees with the cokriging criteria."""
    tt_, ta_ = case["truth"][1], case["approx"][1]
    ck = ta.mloe_mmom(case["obs"], case["pred"], tt_, ta_, nugget=NUGGET, device="cpu")
    naive_loe, _ = ta.naive_multivariate_mloe_mmom(
        case["obs"], case["pred"], tt_, ta_, nugget=NUGGET
    )
    assert abs(float(ck.mloe) - float(naive_loe)) > 1e-6


def test_cokrige_chol_threading(case, monkeypatch):
    """A precomputed Cholesky factor threads through cokrige and
    cokrige_and_score: neither rebuilds Sigma, the predictions are the
    ones without it (and the reference's) within 1e-9, and the deprecation
    warning is emitted once."""
    jt, tt_ = case["truth"]
    obs, pred = case["obs"], case["pred"]
    z = np.random.default_rng(1).normal(size=2 * len(obs))
    truth = np.random.default_rng(2).normal(size=2 * len(pred))
    kw = dict(nugget=NUGGET, device="cpu")
    want = tpred.cokrige(obs, z, pred, tt_, **kw)
    want_scored = tpred.cokrige_and_score(obs, z, pred, truth, tt_, **kw)
    jdata = (jnp.asarray(x) for x in (obs, z, pred))
    ref = jpred.cokrige(*jdata, jt, nugget=NUGGET)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)
    chol = torch.linalg.cholesky(tc.build_sigma(obs, tt_, nugget=NUGGET, device="cpu"))

    def boom(*a, **k):
        raise AssertionError("Sigma was rebuilt despite chol= being passed")

    monkeypatch.setattr(tpred, "build_sigma", boom)
    monkeypatch.setattr(pair_qr, "_warned_fallbacks", set())
    with pytest.warns(RuntimeWarning, match="chol= kwarg is deprecated"):
        got = tpred.cokrige(obs, z, pred, tt_, chol=chol)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one-shot: no second warning
        scored = tpred.cokrige_and_score(obs, z, pred, truth, tt_, chol=chol)
    np.testing.assert_allclose(
        scored.predictions.numpy(), want_scored.predictions.numpy(), rtol=0, atol=1e-9
    )
    assert float(scored.mspe) == pytest.approx(float(want_scored.mspe), rel=1e-9)

"""The port's cokriging serving path (repro_torch.serving.cokrige_service and
repro_torch.core.prediction) against the JAX reference on the CPU in
float64: fit_factor + predict_with_factor at m = 512 against the
reference's and against dense cokriging (the reference's 1e-3 acceptance),
a reference factor carried across, the structured refusals, the jitter
ladder, conditional draws, and that a decode never rebuilds or refactors
Sigma."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import prediction as jpred  # noqa: E402
from repro.core.simulate import simulate_mgrf as j_simulate  # noqa: E402
from repro.serving import cokrige_service as jsvc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import prediction as tpred  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import cokrige_service as svc  # noqa: E402
from repro_torch.testing import corrupt_diag_tile  # noqa: E402

PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
NUGGET = 1e-8
# The two packages factor the same matrix in another order of sums; means,
# variances and bounds agree to this relative to their largest magnitude.
PARITY = 1e-8


def _setup(n_side, seed=0, n_dups=0):
    """test_serving_cokrige.py's geometry: a Morton-ordered jittered grid
    and one reference simulation, shared by both packages as numpy.  With
    ``n_dups``, the last locations copy the first (Sigma singular without a
    nugget), as test_faultinject.py::_dup_setup."""
    locs = grid_locations(n_side, jitter=0.2, seed=seed)
    if n_dups:
        locs[-n_dups:] = locs[:n_dups]
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    z = j_simulate(jax.random.PRNGKey(seed), locs, jp, nugget=NUGGET)[0]
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    return locs, np.asarray(z), jp, tp


def _pred_points(n, seed=3):
    return np.random.default_rng(seed).uniform(0.05, 0.95, size=(n, 2))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def m512():
    """m = 512 (256 locations), tile 64 (T = 8), kmax 24, TLR7: the
    reference's acceptance case.  Both packages fit and predict 48 points."""
    locs, z, jp, tp = _setup(16)
    pred = _pred_points(48)
    jcfg = jsvc.CokrigeServeConfig(tile_size=64, max_rank=24, tol=1e-7, nugget=NUGGET)
    tcfg = svc.CokrigeServeConfig(
        tile_size=64, max_rank=24, tol=1e-7, nugget=NUGGET, gen="kernel"
    )
    jfit, jpredict = jsvc.make_cokrige_serve_fns(jcfg)
    jfactor = jfit(jnp.asarray(locs), jnp.asarray(z), jp)
    jout = jpredict(jfactor, jnp.asarray(pred))
    tfactor = svc.fit_factor(locs, z, tp, tcfg, device="cpu")
    tout = svc.predict_with_factor(tfactor, pred, gen="kernel")
    return dict(
        locs=locs, z=z, jp=jp, tp=tp, pred=pred, tcfg=tcfg,
        jfactor=jfactor, jout=jout, tfactor=tfactor, tout=tout,
    )


def test_fit_and_predict_match_jax_and_dense(m512):
    tf, jf = m512["tfactor"], m512["jfactor"]
    assert tf.kind == "tlr" and tf.status.as_dict()["ok"] and bool(jf.status.ok)
    np.testing.assert_array_equal(tf.ranks.numpy(), np.asarray(jf.ranks))
    assert _rel(tf.alpha, jf.alpha) <= PARITY
    tout, jout = m512["tout"], m512["jout"]
    for field in ("mean", "variance", "lower", "upper"):
        got, want = getattr(tout, field), getattr(jout, field)
        assert got.shape == want.shape
        assert _rel(got, want) <= PARITY, field
    # both within the reference's acceptance of dense cokriging
    locs, z, pred = m512["locs"], m512["z"], m512["pred"]
    dense_t = tpred.cokrige(locs, z, pred, m512["tp"], nugget=NUGGET, device="cpu")
    dense_j = jpred.cokrige(locs, z, pred, m512["jp"], nugget=NUGGET)
    assert _rel(dense_t, dense_j) <= 1e-10
    assert _rel(tout.mean, dense_t) <= 1e-3
    assert _rel(jout.mean, dense_j) <= 1e-3
    var = tout.variance.numpy()
    assert np.all(np.isfinite(var)) and np.all(var >= 0.0)
    assert torch.all(tout.lower <= tout.mean) and torch.all(tout.mean <= tout.upper)
    # the factor= route of the core API runs the same decode
    via_api = tpred.cokrige(None, None, pred, factor=tf)
    np.testing.assert_allclose(via_api.numpy(), tout.mean.numpy(), atol=1e-12)


def test_carried_jax_factor_predicts_the_jax_means(m512):
    jf = m512["jfactor"]
    params = tuple(np.asarray(x) for x in jf.params)
    arrays = (jf.diag_l, jf.u, jf.v, jf.ranks, jf.alpha, jf.locs)
    factor = convert.cokrige_factor_from_numpy(
        *(np.asarray(x) for x in arrays), params, jf.n_shards, z=jf.z, device="cpu"
    )
    got = svc.predict_with_factor(factor, m512["pred"])
    want = m512["jout"]
    for field in ("mean", "variance"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10, err_msg=field)
    with pytest.raises(ValueError, match="n_shards"):
        convert.cokrige_factor_from_numpy(*arrays, params, 8, device="cpu")


def test_dense_factor_route_and_scores_match_jax(m512):
    locs, z, pred = m512["locs"][:64], m512["z"][:128], m512["pred"][:8]
    truth = np.random.default_rng(9).normal(size=16)
    jfac = jpred.dense_factor(locs, z, m512["jp"], nugget=NUGGET)
    tfac = tpred.dense_factor(locs, z, m512["tp"], nugget=NUGGET, device="cpu")
    assert tfac.kind == "dense" and tfac.status.as_dict()["ok"]
    np.testing.assert_allclose(tfac.alpha.numpy(), np.asarray(jfac.alpha), rtol=1e-10)
    # chol= reuses a factor without rebuilding Sigma
    again = tpred.dense_factor(locs, z, m512["tp"], chol=tfac.diag_l)
    np.testing.assert_array_equal(again.alpha.numpy(), tfac.alpha.numpy())
    got = tpred.cokrige_and_score(None, None, pred, truth, factor=tfac)
    want = jpred.cokrige_and_score(None, None, pred, truth, factor=jfac)
    for field in ("predictions", "mspe", "mspe_per_var"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        np.testing.assert_allclose(g, w, rtol=1e-10, err_msg=field)
    np.testing.assert_allclose(
        float(tpred.msrp(got.predictions, torch.as_tensor(truth.reshape(-1, 2)))),
        float(jpred.msrp(want.predictions, jnp.asarray(truth.reshape(-1, 2)))),
        rtol=1e-10,
    )
    dense_pred = svc.predict_with_factor(tfac, pred)
    np.testing.assert_allclose(
        dense_pred.mean.numpy(), got.predictions.numpy(), atol=1e-10
    )


def test_decode_never_rebuilds_or_refactors_sigma(m512, monkeypatch):
    """Repeated decodes against one factor never re-enter GEN of Sigma, the
    compression, the Cholesky or its POTRF tasks."""
    import repro_torch.core.covariance as COV
    import repro_torch.core.tlr as TLR

    def boom(*a, **k):
        raise AssertionError("Sigma was rebuilt or refactored during decode")

    for mod, name in (
        (svc, "dist_compress_tiles"),
        (svc, "dist_tlr_cholesky_pairs"),
        (tpred, "build_sigma"),
        (COV, "build_sigma"),
        (TLR, "compress_columns"),
        (ops, "potrf"),
    ):
        monkeypatch.setattr(mod, name, boom)
    factor, cfg = m512["tfactor"], m512["tcfg"]
    a = svc.predict_batch(factor, _pred_points(8, seed=1), cfg)
    b = svc.predict_batch(factor, _pred_points(8, seed=2), cfg)
    assert torch.isfinite(a.mean).all() and torch.isfinite(b.mean).all()
    a2 = svc.predict_batch(factor, _pred_points(8, seed=1), cfg)
    np.testing.assert_array_equal(a.mean.numpy(), a2.mean.numpy())


def test_conditional_draws_follow_the_conditional_law(m512):
    gen = torch.Generator().manual_seed(2)
    _, predict = svc.make_cokrige_serve_fns(m512["tcfg"])
    pred = m512["pred"][:16]
    out = predict(m512["tfactor"], pred, generator=gen, n_draws=400)
    assert out.draws.shape == (400, 16, 2)
    draws = out.draws.numpy()
    assert np.all(np.isfinite(draws))
    sd = np.sqrt(out.variance.numpy())
    emp = draws.mean(0)
    assert np.max(np.abs(emp - out.mean.numpy())) < 4.0 * np.max(sd) / np.sqrt(400)
    np.testing.assert_allclose(draws.std(0), sd, rtol=0.35, atol=1e-6)
    plain = predict(m512["tfactor"], pred)
    assert plain.draws is None
    np.testing.assert_array_equal(plain.mean.numpy(), out.mean.numpy())


def _broken_fit(locs, z, tp, cfg):
    """fit_factor with diagonal tile 0 made indefinite (the fault injector
    ``repro_torch.testing.corrupt_diag_tile``, magnitude 10, as
    test_faultinject.py breaks the reference's)."""
    with corrupt_diag_tile(tile=0, magnitude=10.0):
        return svc.fit_factor(locs, z, tp, cfg, device="cpu")


def test_serve_errors_refuse_bad_requests_and_broken_factors():
    locs, z, _, tp = _setup(8)
    cfg = svc.CokrigeServeConfig(tile_size=32, max_rank=16, tol=1e-7, nugget=NUGGET)
    factor = _broken_fit(locs, z, tp, cfg)
    st = factor.status.as_dict()
    assert not st["ok"] and st["breakdown_count"] >= 1
    pred = _pred_points(8)
    cases = [
        (np.zeros((4, 3)), "bad_shape"),
        (np.zeros((4, 2), dtype=np.int64), "bad_dtype"),
    ]
    bad = pred.copy()
    bad[2, 0] = np.nan
    cases.append((bad, "nonfinite_locs"))
    cases.append((torch.as_tensor(bad), "nonfinite_locs"))
    for req, code in cases:
        with pytest.raises(svc.ServeError) as ei:
            svc.predict_batch(factor, req, cfg)
        assert ei.value.code == code
    assert ei.value.detail == {"n_nonfinite": 1, "first_row": 2}
    with pytest.raises(svc.ServeError) as ei:
        svc.predict_batch(factor, pred, cfg)
    wire = ei.value.to_dict()
    assert wire["code"] == "broken_factor" and wire["status"]["ok"] is False
    with pytest.raises(svc.ServeError, match="no z") as ei:
        svc.heal_factor(dataclasses.replace(factor, z=None), cfg)
    assert ei.value.code == "broken_factor"


def test_heal_factor_climbs_the_jitter_ladder_as_jax_does():
    """Colliding sensors and no nugget: the factor is broken, the first
    rung (1e-6) heals it in both packages, degraded serving uses the healed
    factor, and its means agree with the reference's."""
    locs, z, jp, tp = _setup(8, n_dups=2)
    kw = dict(tile_size=32, max_rank=16, tol=1e-7, nugget=0.0, degraded=True)
    kw["degraded_initial_jitter"] = 1e-6
    tcfg, jcfg = svc.CokrigeServeConfig(**kw), jsvc.CokrigeServeConfig(**kw)
    factor = svc.fit_factor(locs, z, tp, tcfg, device="cpu")
    jfactor = jsvc.fit_factor(jnp.asarray(locs), jnp.asarray(z), jp, jcfg)
    assert not factor.status.as_dict()["ok"] and not bool(jfactor.status.ok)
    healed = svc.heal_factor(factor, tcfg)
    jhealed = jsvc.heal_factor(jfactor, jcfg)
    assert healed.status.as_dict()["ok"] and bool(jhealed.status.ok)
    pred = _pred_points(8, seed=2)
    out = svc.predict_batch(factor, pred, tcfg)
    ref = svc.predict_batch(healed, pred, tcfg)
    np.testing.assert_allclose(out.mean.numpy(), ref.mean.numpy(), rtol=1e-10)
    want = jsvc.predict_batch(jhealed, jnp.asarray(pred), jcfg)
    assert _rel(out.mean, want.mean) <= 1e-6
    assert svc.heal_factor(healed, tcfg) is healed
    exhausted = dataclasses.replace(
        tcfg, degraded_initial_jitter=0.0, degraded_max_attempts=2
    )
    with pytest.raises(svc.ServeError, match="ladder exhausted") as ei:
        svc.heal_factor(factor, exhausted)
    assert ei.value.detail["jitters_tried"] == [0.0, 0.0]


def test_grouped_super_panel_factor_predicts_what_the_default_predicts(m512):
    """col_block=2 (two columns to a compression SVD batch) and
    super_panels=2 (two super-steps of the factorization) are passed on to
    the compression and the factorization, and change no prediction."""
    cfg = dataclasses.replace(m512["tcfg"], col_block=2, super_panels=2)
    factor = svc.fit_factor(m512["locs"], m512["z"], m512["tp"], cfg, device="cpu")
    assert factor.status.as_dict()["ok"]
    got = svc.predict_with_factor(factor, m512["pred"], gen="kernel")
    want = m512["tout"]
    for field in ("mean", "variance", "lower", "upper"):
        g, w = getattr(got, field).numpy(), getattr(want, field).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(factor.ranks.numpy(), m512["tfactor"].ranks.numpy())


@pytest.mark.parametrize(
    "knob",
    [
        dict(row_axes=("data", "model")),
        dict(shard_svd=False),
        dict(shard_recompress=False),
        dict(gen="pallas"),
    ],
)
def test_config_refuses_what_is_not_ported(knob):
    """A generator name of the reference (``"pallas"``) and a row axis named
    "model" (which always closes the pair axis) are refused by the config.
    The sharding knobs are ported: the config takes them, and only a
    torch.distributed DeviceMesh is taken as the mesh they apply on
    (tests/test_torch_mesh.py serves on W ranks)."""
    if "shard_svd" in knob or "shard_recompress" in knob:
        cfg = svc.CokrigeServeConfig(**knob)
        with pytest.raises(ValueError, match="DeviceMesh"):
            svc.make_cokrige_serve_fns(cfg, object())
    else:
        with pytest.raises(ValueError):
            svc.CokrigeServeConfig(**knob)
    assert svc.CokrigeServeConfig(row_axes=["data"]).row_axes == ["data"]

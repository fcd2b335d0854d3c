"""The port's estimation (repro_torch.core.optimize, .mle, .dst and the
jitter ladder and duplicate check of .recovery) against the JAX reference,
on the CPU in float64: Nelder–Mead follows the reference's simplex path
step for step (same point, value and counters), including its NaN-aware
recenter, aux sums and resume from a reference state; the parameter
transforms; the objective of every ported backend at fixed points; and one
exact-backend fit end to end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import mle as jm  # noqa: E402
from repro.core import optimize as jo  # noqa: E402
from repro.core import recovery as jr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import mle as tm  # noqa: E402
from repro_torch.core import optimize as to  # noqa: E402
from repro_torch.core import recovery as tr  # noqa: E402
from repro_torch.core.simulate import grid_locations, uniform_locations  # noqa: E402

def _vec(values):
    return torch.tensor(values, dtype=torch.float64)


def _rosen(xp):
    return lambda x: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _quad5(xp):
    target = xp.asarray([0.3, -1.0, 2.0, 0.0, 5.0], dtype=xp.float64)
    return lambda x: xp.sum((x - target) ** 2)


def _nan_plateau(xp):
    def fn(x):
        v = xp.sum((x - 1.0) ** 2)
        return xp.where(xp.max(xp.abs(x)) > 1.5, xp.nan, v)

    return fn


def _assert_same_run(got, want):
    """The same simplex path: point, value and both counters."""
    assert int(got.n_iters) == int(want.n_iters)
    assert int(got.n_evals) == int(want.n_evals)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-12)
    assert float(got.value) == pytest.approx(float(want.value), rel=1e-12, abs=1e-15)


@pytest.mark.parametrize(
    "make,x0,max_iters",
    [
        (_rosen, [-1.2, 1.0], 400),
        (_quad5, [0.0] * 5, 500),
        (_nan_plateau, [1.4, 1.4], 300),
    ],
    ids=["rosenbrock", "quadratic5", "nan_region"],
)
def test_nelder_mead_follows_the_reference_path(make, x0, max_iters):
    """test_mle.py's Rosenbrock and 5-D quadratic, and test_recovery.py's
    NaN plateau (recenter-shrink) through both optimizers."""
    want = jo.nelder_mead(make(jnp), jnp.asarray(x0), max_iters=max_iters)
    got = to.nelder_mead(make(torch), _vec(x0), max_iters=max_iters)
    _assert_same_run(got, want)
    assert np.isfinite(float(got.value))


def test_nelder_mead_aux_sums_match_the_reference():
    """test_recovery.py's has_aux case: the summed aux counts are equal."""

    def make(xp, to_int):
        def fn(x):
            v = xp.sum(x**2)
            bad = xp.max(xp.abs(x)) > 0.6
            return xp.where(bad, xp.nan, v), to_int(bad)

        return fn

    want = jo.nelder_mead(
        make(jnp, lambda b: b.astype(jnp.int32)),
        jnp.asarray([0.5, -0.3]),
        max_iters=100,
        has_aux=True,
    )
    got = to.nelder_mead(
        make(torch, lambda b: b.to(torch.int32)),
        _vec([0.5, -0.3]),
        max_iters=100,
        has_aux=True,
    )
    _assert_same_run(got, want)
    assert int(got.aux) == int(want.aux) >= 1


def test_nelder_mead_resumes_a_reference_state():
    """Seven reference iterations carried over (nm_state_from_numpy) and
    resumed in the port equal the reference's one-shot run."""

    def make(xp):
        return lambda x: xp.sum((x - 3.0) ** 2) + x[0] * x[1] * 0.1

    full = jo.nelder_mead(make(jnp), jnp.asarray([0.0, 0.0]), max_iters=100)
    part = jo.nelder_mead(make(jnp), jnp.asarray([0.0, 0.0]), max_iters=7)
    state = convert.nm_state_from_numpy(*(np.asarray(f) for f in part.state))
    assert state.n_iters == 7
    resumed = to.nelder_mead(
        make(torch), _vec([0.0, 0.0]), max_iters=100, init_state=state
    )
    _assert_same_run(resumed, full)
    oneshot = to.nelder_mead(make(torch), _vec([0.0, 0.0]), max_iters=100)
    _assert_same_run(oneshot, full)


def test_multistart_keeps_the_best_start():
    fn = _rosen(torch)
    starts = [_vec([-1.2, 1.0]), _vec([0.9, 0.8])]
    got = to.multistart_nelder_mead(fn, starts, max_iters=30)
    each = [to.nelder_mead(fn, x0, max_iters=30) for x0 in starts]
    assert float(got.value) == min(float(r.value) for r in each)


@pytest.mark.parametrize("profile", [False, True])
def test_pack_unpack_roundtrip_matches_the_reference(profile):
    kw = dict(sigma11=1.3, sigma22=0.7, a=0.12, nu11=0.6, nu22=1.4, beta=-0.35)
    tp = tc.MaternParams.bivariate(**kw, device="cpu")
    x = tm.pack_params(tp, profile)
    want = jm.pack_params(jc.MaternParams.bivariate(**kw), profile)
    assert x.shape == (tm.n_free_params(2, profile),)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-15)
    back = tm.unpack_params(x, 2, profile)
    jback = jm.unpack_params(jnp.asarray(x.numpy()), 2, profile)
    for field in ("sigma2", "a", "nu", "beta"):
        np.testing.assert_allclose(
            getattr(back, field).numpy(), np.asarray(getattr(jback, field)), rtol=1e-15
        )
    assert float(back.a) == pytest.approx(0.12, rel=1e-9)
    assert float(back.beta[0, 1]) == pytest.approx(-0.35, rel=1e-9)
    if not profile:
        np.testing.assert_allclose(back.sigma2.numpy(), [1.3, 0.7], rtol=1e-9)
    x0 = tm.initial_guess(2, profile)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jm.initial_guess(2, profile)))


def test_jitter_escalate_rungs_as_in_the_reference():
    """test_recovery.py's four ladders: clean, climbing, exhausted, capped."""
    clean = tr.jitter_escalate(lambda j: (torch.tensor(-5.0), torch.tensor(True)))
    assert bool(clean.ok) and int(clean.attempts) == 1 and float(clean.jitter) == 0.0
    assert float(clean.loglik) == -5.0

    def climbing(j):
        return (1.23 if j >= 1e-6 else float("nan")), j >= 1e-6

    kw = dict(initial=1e-8, factor=10.0, max_jitter=1e-2, max_attempts=6)
    got = tr.jitter_escalate(climbing, **kw)
    want = jr.jitter_escalate(
        lambda j: (jnp.where(j >= 1e-6, 1.23, jnp.nan), j >= 1e-6), **kw
    )
    assert bool(got.ok) and int(got.attempts) == int(want.attempts) == 4
    assert float(got.jitter) == float(want.jitter) == pytest.approx(1e-6)
    assert float(got.loglik) == pytest.approx(1.23)

    broke = tr.jitter_escalate(lambda j: (float("nan"), False), max_attempts=3)
    assert not bool(broke.ok) and int(broke.attempts) == 3
    assert float(broke.loglik) == tr.sentinel_loglik(torch.float64)

    kw = dict(initial=1e-3, factor=100.0, max_jitter=1e-2, max_attempts=5)
    capped = tr.jitter_escalate(lambda j: (0.0, False), **kw)
    want = jr.jitter_escalate(lambda j: (jnp.asarray(0.0), jnp.asarray(False)), **kw)
    assert float(capped.jitter) == float(want.jitter) == pytest.approx(1e-2)


def test_find_duplicate_locations_lists_what_the_reference_lists():
    rng = np.random.default_rng(0)
    locs = rng.uniform(size=(40, 2))
    near = np.concatenate([locs, locs[5:6], locs[7:8] + 1e-13, locs[:1]], axis=0)
    for case in (locs, near, near[:1], np.zeros((0, 2))):
        got = tr.find_duplicate_locations(case)
        assert got == jr.find_duplicate_locations(case)
    got = tr.find_duplicate_locations(torch.as_tensor(near))
    assert got == [(0, 42), (5, 40), (7, 41)]


@pytest.fixture(scope="module")
def data():
    """n = 40 uniform locations, bivariate (m = 80), Morton-ordered, and a
    data vector made with numpy."""
    locs = uniform_locations(40, seed=3)
    locs = locs[tc.morton_order(locs)]
    z = np.random.default_rng(5).normal(size=2 * len(locs))
    return locs, z


OBJECTIVES = {
    "exact": (dict(backend="exact"), 1e-10),
    "dst": (dict(backend="dst", tile_size=20, dst_keep_fraction=0.7), 1e-10),
    "tlr_dense": (dict(backend="tlr", tile_size=20, tlr_max_rank=16), 1e-9),
    "tlr_tiles": (
        dict(
            backend="tlr",
            tile_size=20,
            tlr_max_rank=16,
            tlr_from_tiles=True,
            profile=False,
        ),
        1e-9,
    ),
}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_objective_matches_the_reference_at_fixed_points(data, name):
    locs, z = data
    kw, rtol = OBJECTIVES[name]
    jkw = dict(kw, gen="pallas") if kw.get("tlr_from_tiles") else kw
    cfg = tm.MLEConfig(p=2, **kw)
    jcfg = jm.MLEConfig(p=2, **jkw)
    got_fn, _ = tm.make_objective(locs, z, cfg, with_aux=True, device="cpu")
    jdata = (jnp.asarray(locs), jnp.asarray(z))
    want_fn, _ = jm.make_objective(*jdata, jcfg, with_aux=True)
    x0 = tm.initial_guess(2, cfg.profile).numpy()
    step = np.random.default_rng(1).normal(scale=0.2, size=(2, x0.size))
    for x in (x0, x0 + step[0], x0 + step[1]):
        got, aux = got_fn(torch.as_tensor(x))
        want, jaux = want_fn(jnp.asarray(x))
        assert float(got) == pytest.approx(float(want), rel=rtol)
        assert aux._asdict().keys() == jaux._asdict().keys()
        for field in aux._fields:
            assert int(getattr(aux, field)) == int(getattr(jaux, field)) == 0


def test_objective_recovery_heals_a_singular_sigma_on_the_first_rung():
    """Three duplicated locations and no nugget make Sigma singular: without
    recovery the objective is clamped to the penalty; with it the ladder's
    first rung (jitter 1e-8) heals it, to the value of a clean objective at
    nugget 1e-8 (test_recovery.py's first-rung case, through the objective)."""
    base = uniform_locations(25, seed=1)
    locs = np.concatenate([base, base[:3]], axis=0)
    z = np.random.default_rng(0).normal(size=2 * len(locs))
    kw = dict(p=2, backend="exact", profile=False, check_duplicates=False)
    x = tm.initial_guess(2, False)

    def value(**cfg):
        fn, _ = tm.make_objective(
            locs, z, tm.MLEConfig(**kw, **cfg), with_aux=True, device="cpu"
        )
        return fn(x)

    broke, aux = value(nugget=0.0)
    assert float(broke) == torch.finfo(torch.float64).max ** 0.5
    assert (int(aux.clamped), int(aux.retries), int(aux.breakdowns)) == (1, 0, 1)
    healed, aux = value(nugget=0.0, recovery=True)
    assert (int(aux.clamped), int(aux.retries), int(aux.breakdowns)) == (0, 1, 1)
    clean, aux = value(nugget=1e-8)
    assert int(aux.clamped) == 0
    assert float(healed) == float(clean)


def test_exact_fit_follows_the_reference(data):
    """One exact-backend fit from the default start (all six parameters
    free): the same iteration and evaluation counts, point and loglik."""
    locs, z = data
    cfg = dict(p=2, backend="exact", profile=False, max_iters=15)
    want = jm.fit(locs, jnp.asarray(z), jm.MLEConfig(**cfg))
    got = tm.fit(locs, z, tm.MLEConfig(**cfg), device="cpu")
    assert got.n_iters == int(want.n_iters) == 15
    assert got.n_evals == int(want.n_evals)
    assert got.converged == bool(want.converged)
    x = tm.pack_params(got.params, False).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jm.pack_params(want.params, False)), rtol=0, atol=1e-8
    )
    assert float(got.loglik) == pytest.approx(float(want.loglik), rel=1e-10)
    assert int(got.clamped_evals) == int(want.clamped_evals) == 0
    assert int(got.recovery_retries) == int(want.recovery_retries) == 0


def test_fit_refuses_duplicates_before_any_evaluation(monkeypatch):
    def no_eval(*args, **kwargs):
        raise AssertionError("evaluated before the duplicate check")

    monkeypatch.setattr(tm, "make_objective", no_eval)
    locs = np.asarray([[0.1, 0.2], [0.3, 0.4], [0.1, 0.2], [0.5, 0.5]])
    with pytest.raises(ValueError, match=r"\(0, 2\).*check_duplicates"):
        tm.fit(locs, np.zeros(8), tm.MLEConfig(p=2, backend="exact"), device="cpu")
    with pytest.raises(ValueError, match="check_duplicates"):
        jm.fit(locs, np.zeros(8), jm.MLEConfig(p=2, backend="exact"))


@pytest.fixture(scope="module")
def grid_data():
    """The geometry at which the reference certifies mixed_f32 (README,
    "Measured (quick bench, m=288)"): 144 Morton-ordered locations of a
    jittered grid, bivariate, and a data vector made with numpy."""
    locs = grid_locations(12, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    z = np.random.default_rng(5).normal(size=2 * len(locs))
    return locs, z


# The knobs the port refused until the distributed forms and the precision
# policy were ported: each config, its data and the tolerance of the
# comparison.  The f64 forms agree at 1e-8 on the n = 40 fixture.  There
# the policy's own error is 1.3e-5 (the reference's mixed_f32 objective
# against its f64 one: f32 singular values at the 1e-7 threshold are
# rounding noise, which the nugget 1e-8 amplifies), so two correct f32
# implementations differ by as much; mixed_f32 is held at the reference's
# certified geometry instead, at test_torch_precision.py's 1e-6.
TILES = dict(backend="tlr", tlr_max_rank=16, profile=False)
KNOBS = {
    "dist_tlr_from_tiles": (dict(dist_tlr_from_tiles=True), "data", 1e-8),
    "block_cyclic": (dict(dist_tlr_from_tiles=True, block_cyclic=True), "data", 1e-8),
    "super_panels": (dict(dist_tlr_from_tiles=True, super_panels=2), "data", 1e-8),
    "dtype_policy": (
        dict(tlr_from_tiles=True, dtype_policy="mixed_f32", tlr_max_rank=24),
        "grid_data",
        1e-6,
    ),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_distributed_and_policy_knobs_match_the_reference(request, knob):
    """Each knob routes as the reference's MLEConfig does: the objective at
    the default start equals the reference's."""
    kw, fixture, rtol = KNOBS[knob]
    locs, z = request.getfixturevalue(fixture)
    tiles = dict(TILES, tile_size=20 if fixture == "data" else 48)
    cfg = tm.MLEConfig(p=2, **dict(tiles, **kw), gen="plain")
    jcfg = jm.MLEConfig(p=2, **dict(tiles, **kw), gen="xla")
    got_fn, dists = tm.make_objective(locs, z, cfg, device="cpu")
    want_fn, _ = jm.make_objective(jnp.asarray(locs), jnp.asarray(z), jcfg)
    assert dists is None  # generator-direct: no (n, n) distances
    x0 = tm.initial_guess(2, False)
    got = float(got_fn(x0))
    assert got == pytest.approx(float(want_fn(jnp.asarray(x0.numpy()))), rel=rtol)
    # the knob is read: the distributed forms give the single-device
    # tiles objective, the policy moves it
    plain_cfg = tm.MLEConfig(p=2, **dict(tiles, tlr_from_tiles=True), gen="plain")
    plain = float(tm.make_objective(locs, z, plain_cfg, device="cpu")[0](x0))
    if knob == "dtype_policy":
        assert got != plain
    else:
        assert got == pytest.approx(plain, rel=1e-12)

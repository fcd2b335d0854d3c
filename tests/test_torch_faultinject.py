"""The port's fault injection (repro_torch.testing) against the JAX
reference's (repro.testing), on the CPU in float64, at the reference's
single-device geometry (tests/test_faultinject.py: an 8^2 jittered grid,
bivariate, tile 32, max rank 16, TLR7): under each injector the port's
status and sentinel loglik equal the reference's under its own injector on
the same inputs; the jitter ladder heals duplicate locations as the
reference's does; serving refuses a broken factor and degraded mode heals
it; the contexts nest and restore the compress functions, also on an
exception; the three fixtures."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.testing as jfi  # noqa: E402
from repro.core import covariance as jc  # noqa: E402
from repro.core import dist_tlr as jdt  # noqa: E402
from repro.core import recovery as jr  # noqa: E402
from repro.core import tlr as jt  # noqa: E402
from repro_torch import testing as tfi  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import dist_tlr as tdt  # noqa: E402
from repro_torch.core import recovery as tr  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.likelihood import exact_loglik  # noqa: E402
from repro_torch.core.simulate import grid_locations, simulate_mgrf  # noqa: E402
from repro_torch.serving import cokrige_service as svc  # noqa: E402
from repro_torch.testing.faultinject import (  # noqa: E402, F401
    corrupt_diag_fault,
    nan_panel_fault,
    zero_shard_fault,
)

PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
NUGGET = 1e-8
TLR_KW = dict(tol=1e-7, max_rank=16, tile_size=32)
LADDER = dict(initial=1e-6, factor=10.0, max_jitter=1e-2, max_attempts=4)


def _setup(n_dups=0):
    """test_faultinject.py's _setup / _dup_setup geometry: a Morton-ordered
    jittered 8^2 grid (with ``n_dups`` locations copied onto the last ones:
    Sigma singular at nugget 0), and one simulation from numpy draws, as
    numpy; both packages get the same inputs."""
    locs = grid_locations(8, jitter=0.2, seed=0)
    if n_dups:
        locs[-n_dups:] = locs[:n_dups]
    locs = locs[tc.morton_order(locs)]
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    eps = np.random.default_rng(0).standard_normal((1, 2 * len(locs)))
    z = simulate_mgrf(None, locs, tp, nugget=NUGGET, eps=eps, device="cpu")[0]
    return locs, z.numpy()


def _jstatus(res):
    st = res.status
    return dict(
        ok=bool(st.ok),
        min_pivot=float(st.min_pivot),
        nonfinite_count=int(st.nonfinite_count),
        breakdown_count=int(st.breakdown_count),
        loglik=float(res.loglik),
    )


def _tstatus(res):
    return dict(res.status.as_dict(), loglik=float(res.loglik))


def _t_single(locs, z, nugget=NUGGET):
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    return tt.tlr_loglik(
        None,
        z,
        tp,
        nugget=nugget,
        locs=locs,
        from_tiles=True,
        gen="plain",
        device="cpu",
        **TLR_KW,
    )


def _j_single(locs, z, nugget=NUGGET):
    jp = jc.MaternParams.bivariate(**PARAMS)
    return jt.tlr_loglik(
        None,
        jnp.asarray(z),
        jp,
        nugget=nugget,
        locs=jnp.asarray(locs),
        from_tiles=True,
        gen="xla",
        **TLR_KW,
    )


def _t_dist(locs, z):
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    return tdt.dist_tlr_loglik(
        None,
        z,
        locs=locs,
        params=tp,
        from_tiles=True,
        nugget=NUGGET,
        block_cyclic=True,
        gen="plain",
        device="cpu",
        **TLR_KW,
    )


def _j_dist(locs, z):
    return jdt.dist_tlr_loglik(
        z=jnp.asarray(z),
        locs=jnp.asarray(locs),
        params=jc.MaternParams.bivariate(**PARAMS),
        from_tiles=True,
        nugget=NUGGET,
        block_cyclic=True,
        gen="xla",
        **TLR_KW,
    )


# the injected faults: (injector name, its arguments, the evaluation)
FAULTS = {
    "corrupt_diag": ("corrupt_diag_tile", dict(tile=0, magnitude=10.0), "single"),
    "nan_panel": ("nan_compress_panel", dict(panel=1), "single"),
    "zero_shard": ("zero_shard", dict(shard=0, n_shards=4), "dist"),
}
# ROADMAP Queue 3, by design: a non-finite recompress singular value is
# counted only while its pair is active (the reference's masked grid form
# counts it over all T^2 tiles).  Each fault here sends NaN into the
# recompress (a broken POTRF tile is NaN, and so is every update made from
# it), so nonfinite_count is smaller than the reference's but nonzero with
# it (129 against 577 under corrupt_diag); every other field is equal.


@pytest.fixture(scope="module")
def reference():
    """The reference's statuses (clean and under each of its injectors) and
    its jitter ladder on the duplicated geometry, computed once (about 17 s,
    most of it the first eager TLR evaluation's compiles)."""
    locs, z = _setup()
    evals = {"single": _j_single, "dist": _j_dist}
    out = {"clean": _jstatus(_j_single(locs, z))}
    for name, (inject, kw, path) in FAULTS.items():
        with getattr(jfi, inject)(**kw):
            out[name] = _jstatus(evals[path](locs, z))
    dlocs, dz = _setup(n_dups=2)

    def eval_at(j):
        r = _j_single(dlocs, dz, nugget=j)
        return r.loglik, r.status.ok & jnp.isfinite(r.loglik)

    rec = jr.jitter_escalate(eval_at, **LADDER)
    out["ladder"] = dict(
        ok=bool(rec.ok),
        attempts=int(rec.attempts),
        jitter=float(rec.jitter),
        loglik=float(rec.loglik),
    )
    return out


@pytest.mark.parametrize("fault", list(FAULTS))
def test_injected_fault_status_equals_the_reference(reference, fault):
    locs, z = _setup()
    clean = _tstatus(_t_single(locs, z))
    assert clean["ok"] and reference["clean"]["ok"]
    assert clean["loglik"] == pytest.approx(reference["clean"]["loglik"], rel=1e-9)

    inject, kw, path = FAULTS[fault]
    evaluate = {"single": _t_single, "dist": _t_dist}[path]
    with getattr(tfi, inject)(**kw):
        got = _tstatus(evaluate(locs, z))
    want = reference[fault]
    assert not got["ok"] and not want["ok"]
    assert got["breakdown_count"] == want["breakdown_count"]
    assert got["loglik"] == want["loglik"] == tr.sentinel_loglik(torch.float64)
    assert got["min_pivot"] == want["min_pivot"]
    assert 0 < got["nonfinite_count"] <= want["nonfinite_count"]
    if fault == "corrupt_diag":
        assert got["breakdown_count"] >= 1
    elif fault == "nan_panel":
        assert got["nonfinite_count"] + got["breakdown_count"] >= 1
    else:
        assert got["min_pivot"] <= 0.0  # a zeroed diagonal tile: pivot 0

    # the context is scoped: a clean evaluation after it, bit for bit
    assert _tstatus(_t_single(locs, z)) == clean


def test_jitter_ladder_heals_duplicates_as_the_reference(reference):
    """Colliding sensors at nugget 0: the zero-jitter attempt breaks, the
    first rung (1e-6) heals, and the loglik equals the reference ladder's
    and a dense exact evaluation at that jitter."""
    locs, z = _setup(n_dups=2)
    broken = _t_single(locs, z, nugget=0.0)
    assert not broken.status.as_dict()["ok"]
    assert np.isfinite(float(broken.loglik))

    def eval_at(j):
        r = _t_single(locs, z, nugget=j)
        return r.loglik, r.status.ok & torch.isfinite(r.loglik)

    rec = tr.jitter_escalate(eval_at, **LADDER)
    want = reference["ladder"]
    assert bool(rec.ok) and want["ok"]
    assert int(rec.attempts) == want["attempts"] == 2
    assert float(rec.jitter) == want["jitter"] == pytest.approx(1e-6)
    assert float(rec.loglik) == pytest.approx(want["loglik"], rel=1e-9)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    dense = exact_loglik(locs, z, tp, nugget=float(rec.jitter), device="cpu")
    assert float(rec.loglik) == pytest.approx(float(dense.loglik), rel=1e-3)


def test_serving_refuses_the_injected_fault_and_degraded_mode_heals():
    locs, z = _setup()
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    cfg = svc.CokrigeServeConfig(nugget=NUGGET, **TLR_KW)
    with tfi.corrupt_diag_tile(tile=0, magnitude=10.0):
        factor = svc.fit_factor(locs, z, tp, cfg, device="cpu")
    assert not factor.status.as_dict()["ok"]
    pred = np.random.default_rng(1).uniform(0.1, 0.9, size=(8, 2))
    with pytest.raises(svc.ServeError) as ei:
        svc.predict_batch(factor, pred, cfg)
    wire = ei.value.to_dict()
    assert wire["code"] == "broken_factor" and wire["status"]["ok"] is False
    with pytest.raises(svc.ServeError, match="no z"):
        svc.heal_factor(dataclasses.replace(factor, z=None), cfg)

    dlocs, dz = _setup(n_dups=2)
    dcfg = svc.CokrigeServeConfig(
        nugget=0.0, degraded=True, degraded_initial_jitter=1e-6, **TLR_KW
    )
    broken = svc.fit_factor(dlocs, dz, tp, dcfg, device="cpu")
    assert not broken.status.as_dict()["ok"]
    healed = svc.heal_factor(broken, dcfg)
    assert healed.status.as_dict()["ok"]
    out = svc.predict_batch(broken, pred, dcfg)  # degraded end to end
    assert torch.isfinite(out.mean).all() and (out.variance >= 0).all()
    ref = svc.predict_batch(healed, pred, dcfg)
    np.testing.assert_allclose(out.mean.numpy(), ref.mean.numpy(), rtol=1e-10)


_SITES = (
    (tt, "tlr_compress_tiles"),
    (tdt, "dist_compress_tiles"),
    (svc, "dist_compress_tiles"),
)


def _patched():
    return [getattr(mod, name) for mod, name in _SITES]


def test_contexts_nest_and_restore_on_exit_and_on_an_exception():
    locs, z = _setup()
    originals = _patched()
    with tfi.corrupt_diag_tile(tile=0, magnitude=10.0):
        outer = _patched()
        with tfi.zero_shard(shard=3, n_shards=4):
            both = _tstatus(_t_single(locs, z))
        assert _patched() == outer
        one = _tstatus(_t_single(locs, z))
    assert _patched() == originals
    # the outer fault breaks tile 0 either way; the inner one adds pivot 0
    # at tile 3, and the two injectors compose in one evaluation
    assert not one["ok"] and not both["ok"]
    assert both["breakdown_count"] >= one["breakdown_count"] >= 1
    with pytest.raises(RuntimeError, match="inside"):
        with tfi.nan_compress_panel(panel=1):
            assert _patched() != originals
            raise RuntimeError("inside")
    assert _patched() == originals
    assert _tstatus(_t_single(locs, z))["ok"]


@pytest.mark.parametrize(
    "fixture", ["corrupt_diag_fault", "nan_panel_fault", "zero_shard_fault"]
)
def test_fixtures_inject_their_fault(request, fixture):
    """Each fixture at its defaults, on the pair-major path (where slot 0,
    the one nan_panel_fault poisons, holds a tile; in the grid form it is
    row 0 of tiles, which holds none, and the injector raises there)."""
    locs, z = _setup()
    originals = _patched()
    request.getfixturevalue(fixture)
    assert _patched() != originals
    got = _tstatus(_t_dist(locs, z))
    assert not got["ok"]
    assert got["loglik"] == tr.sentinel_loglik(torch.float64)


def test_nan_panel_on_an_empty_grid_row_raises():
    """Row 0 of the grid form holds no tile: the default nan_compress_panel
    on the single-device path raises instead of injecting nothing."""
    locs, z = _setup()
    with tfi.nan_compress_panel():
        with pytest.raises(ValueError, match="holds no tile"):
            _t_single(locs, z)

"""The port's exact panel-form Cholesky (repro_torch.core.dist_cholesky) and
its SYRK kernel's plain version against the JAX reference, on the CPU in
float64: the tile tasks, the blocked factor at three panel widths, the
solves, the log-likelihood end to end, the kernels the path reaches, and a
breakdown.  The CUDA syrk kernel itself is held against ``syrk_ref`` on the
card by chip_smoke.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import dist_cholesky as jd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chol_tiles import potrf as j_potrf  # noqa: E402
from repro.kernels.chol_tiles import syrk as j_syrk  # noqa: E402
from repro.kernels.chol_tiles import trsm as j_trsm  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import dist_cholesky as td  # noqa: E402
from repro_torch.core.likelihood import exact_loglik  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.chol_tiles import (  # noqa: E402
    syrk_cuda,
    syrk_grid,
    syrk_tile,
)

PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
NUGGET = 1e-8
FIELDS = ("loglik", "logdet", "quad")
TIGHT = dict(rtol=1e-10, atol=1e-10)  # the solves, port against reference


def _tol(name):
    # as tests/test_kernels.py::_tol
    if name == "float32":
        return dict(rtol=2e-3, atol=1e-3)
    return dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def case():
    """m = 288 (n = 144 Morton-ordered locations, bivariate), as
    tests/test_distributed.py::_setup: the reference's Sigma and distances,
    a data vector and a block of right-hand sides."""
    locs = grid_locations(12, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    dists = np.asarray(jc.pairwise_distances(jnp.asarray(locs)))
    build = jax.jit(lambda d: jc.build_sigma(None, jp, dists=d, nugget=NUGGET))
    sigma = np.asarray(build(jnp.asarray(dists)))
    rng = np.random.default_rng(0)
    z = rng.normal(size=sigma.shape[0])
    rhs = rng.normal(size=(sigma.shape[0], 3))
    return dict(
        locs=locs,
        jp=jp,
        tp=tc.MaternParams.bivariate(**PARAMS, device="cpu"),
        dists=dists,
        sigma=sigma,
        z=z,
        rhs=rhs,
    )


@pytest.fixture(scope="module")
def jax_panels(case):
    """The reference's panel factor at panel 48, jitted once."""
    fn = jax.jit(lambda a: jd.blocked_cholesky_panels(a, 48))
    return fn(jnp.asarray(case["sigma"]))


@pytest.mark.parametrize("b,nb,k", [(2, 64, 64), (4, 32, 16)])
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_syrk_ref_matches_pallas(b, nb, k, dname):
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    rng = np.random.default_rng(4)
    c, a = rng.normal(size=(b, nb, nb)), rng.normal(size=(b, nb, k))
    want = j_syrk(jnp.asarray(c, jdt), jnp.asarray(a, jdt), interpret=True)
    plain = jref.syrk_ref(jnp.asarray(c, jdt), jnp.asarray(a, jdt))
    got = ref.syrk_ref(torch.as_tensor(c, dtype=tdt), torch.as_tensor(a, dtype=tdt))
    assert got.dtype == tdt and got.shape == (b, nb, nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dname))
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), **_tol(dname))


def test_tile_cholesky_composition():
    """POTRF + TRSM + SYRK compose into a correct 2x2-block factorization,
    in the port's dispatch as in tests/test_kernels.py with the Pallas
    kernels; the two agree tile by tile."""
    nb = 64
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2 * nb, 2 * nb))
    a = x @ x.T + 2 * nb * np.eye(2 * nb)
    a11, a21, a22 = a[:nb, :nb], a[nb:, :nb], a[nb:, nb:]
    t = torch.as_tensor
    l11 = ops.potrf(t(a11)[None])[0]
    l21 = ops.trsm(l11[None], t(a21.T)[None])[0].T
    s22 = ops.syrk(t(a22)[None], l21[None])[0]
    l22 = ops.potrf(s22[None])[0]
    lo = np.block([[l11.numpy(), np.zeros((nb, nb))], [l21.numpy(), l22.numpy()]])
    np.testing.assert_allclose(lo @ lo.T, a, rtol=1e-9, atol=1e-9)
    j11 = j_potrf(jnp.asarray(a11)[None], interpret=True)[0]
    j21 = j_trsm(j11[None], jnp.asarray(a21.T)[None], interpret=True)[0].T
    j22 = j_syrk(jnp.asarray(a22)[None], j21[None], interpret=True)[0]
    np.testing.assert_allclose(l21.numpy(), np.asarray(j21), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(s22.numpy(), np.asarray(j22), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("panel", [32, 96, 288])
def test_blocked_cholesky_matches_jax(case, panel):
    want = jax.jit(lambda a: jd.blocked_cholesky(a, panel))(jnp.asarray(case["sigma"]))
    got = td.blocked_cholesky(case["sigma"], panel, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        got.numpy(), np.linalg.cholesky(case["sigma"]), rtol=0, atol=1e-8
    )


def test_panel_solves_and_logdet_match_jax(case, jax_panels):
    panel = 48
    got = td.blocked_cholesky_panels(case["sigma"], panel, device="cpu")
    assert len(got) == len(jax_panels) == 6 and got[-1][1] is None
    for (lk, pk), (jlk, jpk) in zip(got, jax_panels):
        np.testing.assert_allclose(lk.numpy(), np.asarray(jlk), atol=1e-12)
        if pk is not None:
            np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), atol=1e-12)
    fwd_j = jax.jit(lambda p, y: jd.panels_forward_solve(p, y, panel))
    bwd_j = jax.jit(lambda p, y: jd.panels_backward_solve(p, y, panel))
    for rhs in (case["z"], case["rhs"]):
        want = fwd_j(jax_panels, jnp.asarray(rhs))
        fwd = td.panels_forward_solve(got, rhs, panel)
        assert fwd.shape == rhs.shape
        np.testing.assert_allclose(fwd.numpy(), np.asarray(want), **TIGHT)
        want = bwd_j(jax_panels, jnp.asarray(rhs))
        bwd = td.panels_backward_solve(got, rhs, panel)
        assert bwd.shape == rhs.shape
        np.testing.assert_allclose(bwd.numpy(), np.asarray(want), **TIGHT)
    want = float(jd.panels_logdet(jax_panels))
    assert float(td.panels_logdet(got)) == pytest.approx(want, rel=1e-13)


def test_forward_substitution_matches_jax(case):
    lfac = np.linalg.cholesky(case["sigma"])
    fwd_j = jax.jit(lambda lo, y: jd.forward_substitution(lo, y, panel=32))
    for rhs in (case["z"], case["rhs"]):
        want = fwd_j(jnp.asarray(lfac), jnp.asarray(rhs))
        got = td.forward_substitution(lfac, rhs, panel=32, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_dist_exact_loglik_matches_jax_and_dense(case):
    want = jd.dist_exact_loglik(
        jnp.asarray(case["dists"]),
        jnp.asarray(case["z"]),
        case["jp"],
        nugget=NUGGET,
        panel=36,
    )
    times = {}
    got = td.dist_exact_loglik(
        case["dists"],
        case["z"],
        case["tp"],
        nugget=NUGGET,
        panel=36,
        device="cpu",
        times=times,
    )
    assert got.status is None and set(times) == {"gen", "factorize", "solve"}
    for field in FIELDS:
        g, w = float(getattr(got, field)), float(getattr(want, field))
        assert g == pytest.approx(w, rel=1e-12), field
    dense = exact_loglik(
        None, case["z"], case["tp"], nugget=NUGGET, dists=case["dists"], device="cpu"
    )
    assert float(got.loglik) == pytest.approx(float(dense.loglik), rel=1e-9)


def test_exact_path_runs_through_the_tile_kernels(case, monkeypatch):
    """The panel path calls ops.syrk nk - 1 times, ops.potrf nk times and
    ops.trsm 2 nk - 1 times (nk - 1 panel TRSMs, nk forward blocks)."""
    calls = {"potrf": 0, "trsm": 0, "syrk": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(ops, name, spy)
    panel = 36
    nk = case["sigma"].shape[0] // panel
    td.dist_exact_loglik(
        case["dists"], case["z"], case["tp"], nugget=NUGGET, panel=panel, device="cpu"
    )
    assert calls == {"potrf": nk, "trsm": 2 * nk - 1, "syrk": nk - 1}


def test_non_spd_sigma_gives_nan_loglik_as_in_jax(case):
    """A cross-correlation beyond 1 makes Sigma indefinite: the failed
    POTRF's NaN flows through TRSM and SYRK into a NaN loglik in both."""
    bad = dict(PARAMS, beta=1.5)
    want = jd.dist_exact_loglik(
        jnp.asarray(case["dists"]),
        jnp.asarray(case["z"]),
        jc.MaternParams.bivariate(**bad),
        nugget=NUGGET,
        panel=36,
    )
    got = td.dist_exact_loglik(
        case["dists"],
        case["z"],
        tc.MaternParams.bivariate(**bad, device="cpu"),
        nugget=NUGGET,
        panel=36,
        device="cpu",
    )
    assert math.isnan(float(want.loglik))
    assert math.isnan(float(got.loglik))


def test_unported_and_invalid_arguments_raise(case):
    # a mesh must be a torch.distributed DeviceMesh (tests/test_torch_mesh.py
    # runs the mesh form on W ranks)
    with pytest.raises(ValueError, match="DeviceMesh"):
        td.dist_exact_loglik(
            case["dists"], case["z"], case["tp"], mesh=object(), device="cpu"
        )
    with pytest.raises(ValueError, match="does not divide"):
        td.blocked_cholesky_panels(case["sigma"], 100, device="cpu")


def test_syrk_wrapper_indexes_in_64_bits_and_refuses_what_it_cannot():
    """The grid of the exact path's first step, and nb past 2^31 elements a
    matrix (offsets are 64-bit), are accepted; a batch past grid.y and a
    tile count past grid.x are refused; CPU tensors are refused."""
    assert syrk_grid(1, 32256, 512) == (504 * 505 // 2, 1)
    nb = 46341  # nb^2 > 2^31
    assert nb * nb >= 2**31 and syrk_grid(1, nb, 64) == (725 * 726 // 2, 1)
    with pytest.raises(ValueError, match="too large"):
        syrk_grid(65536, 64, 8)
    with pytest.raises(ValueError, match="too large"):
        syrk_grid(1, 64 * 65536, 8)
    c = torch.zeros((2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        syrk_cuda(c, torch.zeros((2, 8, 4), dtype=torch.float64))


H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def _emulate_syrk_dmma_f64(c, a, tile):
    """The dmma_f64 syrk instance's order of work in plain torch: one
    product P = A_I A_J^T per lower-triangle tile (ti >= tj) of edge
    ``tile`` (the tiles are independent, so their order does not matter);
    out[I, J] = C[I, J] - P, and an off-diagonal tile also writes out[J, I]
    = C[J, I] - P^T.  out starts as NaN, so a position no tile writes
    shows."""
    nb = c.shape[1]
    side = -(-nb // tile)
    out = torch.full_like(c, math.nan)
    for ti, tj in ((ti, tj) for ti in range(side) for tj in range(ti + 1)):
        rows = slice(ti * tile, (ti + 1) * tile)
        cols = slice(tj * tile, (tj + 1) * tile)
        p = a[:, rows] @ a[:, cols].mT
        out[:, rows, cols] = c[:, rows, cols] - p
        if ti != tj:
            out[:, cols, rows] = c[:, cols, rows] - p.mT
    return out


@pytest.mark.parametrize(
    "b,nb,k,tile",
    [
        (2, 64, 64, 64),
        (4, 32, 16, 64),
        (2, 200, 37, 64),  # ragged: four tile rows, the last of 8
        (2, 200, 37, 128),
        (3, 50, 1, 64),  # k = 1
    ],
)
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_dmma_syrk_order_of_work_matches_pallas(b, nb, k, tile, dname):
    """The f64 CUDA syrk instance's order of work (lower tiles, the
    transposed write) against the Pallas syrk in interpret mode, at the
    shapes and tolerances of test_syrk_ref_matches_pallas, plus a ragged nb
    at both tile edges and k = 1; every element is written."""
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    rng = np.random.default_rng(4)
    c, a = rng.normal(size=(b, nb, nb)), rng.normal(size=(b, nb, k))
    got = _emulate_syrk_dmma_f64(
        torch.as_tensor(c, dtype=tdt), torch.as_tensor(a, dtype=tdt), tile
    )
    assert not bool(torch.isnan(got).any())
    want = j_syrk(jnp.asarray(c, jdt), jnp.asarray(a, jdt), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dname))


@pytest.mark.parametrize(
    "batch,nb,want",
    [
        (1, 32256, 128),  # exact path, panel 512, first step: 31878 tiles
        (1, 28672, 128),  # panel 4096, first step
        (1, 4096, 128),  # 528 tiles: four waves
        (1, 512, 64),  # the path's last steps: 64 x 64 tiles
        (4, 512, 64),
        (1, 46341, 128),
    ],
)
def test_dmma_syrk_tile(batch, nb, want):
    assert syrk_tile(batch, nb, H100_SMS) == want


def test_dist_exact_loglik_float32_matches_jax_and_dense(case):
    """The reference's float32 exact path (``dist_loglik_lowerable``'s
    default dtype and nugget 1e-6): distances, Matérn parameters and z in
    float32, so POTRF, TRSM and SYRK run in float32 (their fma_f32
    instances on the card).  The port against the reference's float32
    evaluation at 1e-5 (two float32 evaluations that sum in other orders),
    and against the float64 dense loglik at the reference's float32
    tolerance (tests/test_distributed.py: 1e-3)."""
    nugget, f32 = 1e-6, torch.float32
    jp = jc.MaternParams.bivariate(**PARAMS, dtype=jnp.float32)
    tp = tc.MaternParams.bivariate(**PARAMS, dtype=f32, device="cpu")
    dists, z = case["dists"].astype(np.float32), case["z"].astype(np.float32)
    want = jax.jit(
        lambda d, y: jd.dist_exact_loglik(d, y, jp, nugget=nugget, panel=36)
    )(jnp.asarray(dists), jnp.asarray(z))
    # tensors keep their dtype (numpy input would be taken as float64)
    dt, zt = torch.as_tensor(dists), torch.as_tensor(z)
    got = td.dist_exact_loglik(dt, zt, tp, nugget=nugget, panel=36)
    assert got.loglik.dtype == f32 and want.loglik.dtype == jnp.float32
    for field in FIELDS:
        g, w = float(getattr(got, field)), float(getattr(want, field))
        assert g == pytest.approx(w, rel=1e-5), field
    dense = exact_loglik(
        None, case["z"], case["tp"], nugget=nugget, dists=case["dists"], device="cpu"
    )
    assert float(got.loglik) == pytest.approx(float(dense.loglik), rel=1e-3)

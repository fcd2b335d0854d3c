"""The port's entry-point helpers and the paper's three geostat examples
(examples/torch/) against the JAX reference, on the CPU in float64:
``split_train_pred``, ``morton_sorted_locations``, the paper's parameter
tables and ``wrf_like_params``, ``matern_covariance`` and
``effective_range``; then each example's ``main`` with ``--device cpu`` at
a reduced size against the reference's functions called the same way on
the same field (the examples draw their normals on the CPU, so the
reference is handed the port's z)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import assessment as jass  # noqa: E402
from repro.core import covariance as jc  # noqa: E402
from repro.core import likelihood as jl  # noqa: E402
from repro.core import matern as jmat  # noqa: E402
from repro.core import mle as jm  # noqa: E402
from repro.core import prediction as jpred  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core import tlr as jt  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import matern as tmat  # noqa: E402
from repro_torch.core import mle as tm  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
LEVELS = {"TLR5": 1e-5, "TLR7": 1e-7, "TLR9": 1e-9}
# the MLEConfig fields that bivariate_fit_predict sets
REF_FIELDS = ("p", "profile", "backend", "tlr_tol", "tlr_max_rank", "tile_size",
              "max_iters", "nugget")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_torch_example_{name}", EXAMPLES / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("representation", ["I", "II"])
def test_split_train_pred_matches_the_reference(p, representation):
    locs = tsim.uniform_locations(30, seed=4)
    z = np.random.default_rng(2).normal(size=(3, p * len(locs)))
    kw = dict(seed=7, p=p, representation=representation)
    got = tsim.split_train_pred(locs, z, 6, **kw)
    want = jsim.split_train_pred(locs, z, 6, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a tensor z keeps its type and gives the same rows
    gott = tsim.split_train_pred(locs, torch.as_tensor(z), 6, **kw)
    np.testing.assert_array_equal(gott[1].numpy(), want[1])
    np.testing.assert_array_equal(gott[3].numpy(), want[3])


def test_tables_wrf_params_and_morton_sort_match_the_reference():
    assert tsim.PAPER_TABLE1_BIVARIATE == jsim.PAPER_TABLE1_BIVARIATE
    assert tsim.PAPER_TABLE2_TRIVARIATE == jsim.PAPER_TABLE2_TRIVARIATE
    for kind in ("bivariate", "trivariate"):
        got = tsim.wrf_like_params(kind, device="cpu")
        want = jsim.wrf_like_params(kind)
        for field in got._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field))
            )
    f32 = tsim.wrf_like_params(dtype=torch.float32, device="cpu")
    assert f32.a.dtype == torch.float32
    with pytest.raises(ValueError):
        tsim.wrf_like_params("univariate", device="cpu")
    locs = tsim.uniform_locations(50, seed=1)
    got, perm = tsim.morton_sorted_locations(locs)
    want, jperm = jsim.morton_sorted_locations(locs)
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_matern_covariance_and_effective_range_match_the_reference():
    """test_matern.py's effective-range case (ER = {0.1, 0.3, 0.7} at
    a = {0.03, 0.09, 0.2}, nu = 0.5), vectorised and one by one, a general
    order, and the marginal covariance at three orders."""
    a = (0.03, 0.09, 0.2)
    for nu in (0.5, 1.3):
        got = tmat.effective_range(torch.tensor(a, dtype=torch.float64), nu)
        want = np.asarray(jmat.effective_range(jnp.asarray(a), nu))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    ers = [float(tmat.effective_range(ai, 0.5, device="cpu")) for ai in a]
    np.testing.assert_allclose(ers, [0.0899, 0.2696, 0.599], rtol=0.02)
    h = np.linspace(0.0, 0.8, 9)
    for nu in (0.5, 1.0, 1.7):
        got = tmat.matern_covariance(h, 1.7, 0.12, nu, device="cpu")
        want = jmat.matern_covariance(jnp.asarray(h), 1.7, 0.12, nu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def _jparams(**kw):
    return jc.MaternParams.bivariate(**kw)


def test_quickstart_main_matches_the_reference():
    """n = 6^2, tile 24 (the script's 20^2 and 100 cut for time; the
    reference's compiles at these shapes serve the next test too)."""
    argv = ["--device", "cpu", "--n-side", "6", "--tile", "24"]
    got = _example("quickstart").main(argv)
    locs = jsim.grid_locations(6, jitter=0.3, seed=0)
    locs = locs[jc.morton_order(locs)]
    params = _jparams(sigma11=1.0, sigma22=1.0, a=0.2, nu11=0.5, nu22=1.0, beta=0.5)
    z = jnp.asarray(got["z"])
    dists = jc.pairwise_distances(locs)
    ll = jl.exact_loglik(None, z, params, dists=dists, nugget=1e-10)
    assert got["n"] == 36
    assert got["exact_loglik"] == pytest.approx(float(ll.loglik), rel=1e-10)
    assert got["z_var"] == pytest.approx(float(jnp.var(z)), rel=1e-12)
    sigma = jc.build_sigma(None, params, dists=dists, nugget=1e-10)
    for name, tol in LEVELS.items():
        t = jt.tlr_compress(sigma, tile_size=24, tol=tol, max_rank=64)
        want = jt.tlr_loglik(
            dists, z, params, tol=tol, max_rank=64, tile_size=24, nugget=1e-10
        )
        row = got["tlr"][name]
        assert row["loglik"] == pytest.approx(float(want.loglik), rel=1e-9)
        assert row["tlr_bytes"] == jt.memory_footprint(t)["tlr_bytes"]


def test_tlr_vs_exact_main_matches_the_reference():
    """n = 6^2, tile 24 (the script's 18^2 and 108 cut for time); the
    reference's gen="pallas" is the port's gen="kernel".  The reference
    evaluates one accuracy a strength (TLR5 weak, TLR7 moderate, TLR9
    strong: every strength and every accuracy once), a third of the table,
    for time (its eager calls compile for each accuracy and shape)."""
    argv = ["--device", "cpu", "--n-side", "6", "--tile", "24"]
    got = _example("tlr_vs_exact").main(argv)
    locs = jsim.grid_locations(6, jitter=0.2, seed=0)
    locs = jnp.asarray(locs[jc.morton_order(locs)])
    dists = jc.pairwise_distances(locs)
    assert len(got["rows"]) == 9
    for row in got["rows"][::4]:
        params = _jparams(a=row["a"], nu11=0.5, nu22=1.0, beta=0.5)
        z = jnp.asarray(row["z"])
        tol = LEVELS[row["accuracy"]]
        kw = dict(tol=tol, max_rank=64, tile_size=24, nugget=1e-8)
        exact = jl.exact_loglik(None, z, params, dists=dists, nugget=1e-8)
        assert row["exact_loglik"] == pytest.approx(float(exact.loglik), rel=1e-10)
        t = jt.tlr_compress_tiles(locs, params, gen="pallas", **kw)
        tiles = jt.tlr_loglik(
            None, z, params, locs=locs, from_tiles=True, gen="pallas", **kw
        )
        dense = jt.tlr_loglik(dists, z, params, **kw)
        assert row["loglik"] == pytest.approx(float(tiles.loglik), rel=1e-9)
        assert row["loglik_dense"] == pytest.approx(float(dense.loglik), rel=1e-9)
        ranks = np.asarray(t.ranks)
        assert row["mean_rank"] == ranks[np.tril_indices(t.n_tiles, -1)].mean()
        assert row["mem_ratio"] == pytest.approx(jt.memory_footprint(t)["ratio"])


@pytest.mark.parametrize("backend", ["exact", "tlr"])
def test_bivariate_fit_predict_main_matches_the_reference(backend):
    """n = 40 + 8 held out, 6 iterations, tile 40 for TLR7 (the script's
    300 + 30, 80 and 100 cut for time): the same simplex path (counts,
    point and loglik) as the reference's fit on the same field, then the
    same MSPE and MLOE/MMOM at the fitted parameters."""
    argv = ["--device", "cpu", "--n", "40", "--npred", "8", "--max-iters", "6"]
    argv += ["--tile", "40"] + (["--tlr"] if backend == "tlr" else [])
    got = _example("bivariate_fit_predict").main(argv)
    truth = _jparams(sigma11=1.0, sigma22=1.0, a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
    locs = jsim.uniform_locations(48, seed=0)
    split = jsim.split_train_pred(locs, got["z"], 8, seed=0, p=2)
    obs, z_obs, pred, z_pred = split[:4]
    cfg = jm.MLEConfig(
        p=2,
        profile=True,
        backend=backend,
        tlr_tol=1e-7,
        tlr_max_rank=32,
        tile_size=40,
        max_iters=6,
        nugget=1e-8,
    )
    res = jm.fit(obs, jnp.asarray(z_obs), cfg)
    assert got["backend"] == backend
    assert (got["n_iters"], got["n_evals"]) == (int(res.n_iters), int(res.n_evals))
    assert got["loglik"] == pytest.approx(float(res.loglik), rel=1e-10)
    assert got["loglik"] >= got["loglik_start"]
    est = res.params
    np.testing.assert_allclose(got["sigma2"], np.asarray(est.sigma2), rtol=1e-7)
    np.testing.assert_allclose(got["nu"], np.asarray(est.nu), rtol=1e-7)
    assert got["a"] == pytest.approx(float(est.a), rel=1e-7)
    assert got["beta"] == pytest.approx(float(est.beta[0, 1]), rel=1e-7)
    score = jpred.cokrige_and_score(
        obs, jnp.asarray(z_obs), pred, jnp.asarray(z_pred), est, nugget=1e-8
    )
    assert got["mspe"] == pytest.approx(float(score.mspe), rel=1e-6)
    crit = jass.mloe_mmom(obs, pred, truth, est, nugget=1e-8)
    assert got["mloe"] == pytest.approx(float(crit.mloe), rel=1e-6, abs=1e-10)
    assert got["mmom"] == pytest.approx(float(crit.mmom), rel=1e-6, abs=1e-10)
    assert got["mloe"] >= -1e-9


def test_bivariate_tlr_objective_matches_the_reference_at_the_script_size():
    """bivariate_fit_predict's own size (n = 300 + 30, tile 100, rank 32,
    TLR7): the port's TLR7 objective on the script's field equals the
    reference's near where the script's exact and TLR7 fits end (a = 0.128
    and a = 2.24), and it is higher at the exact fit's end than where the
    TLR7 fit stops after its 80 iterations: that fit's lower loglik is
    where the search stops, not the surface."""
    ex = _example("bivariate_fit_predict")
    _, obs, z_obs, *_ = ex.problem(300, 30, "cpu")
    cfg = ex.mle_config("tlr", 100, 80)
    fn = ex.objective(obs, z_obs, cfg, "cpu")
    jcfg = jm.MLEConfig(**{f: getattr(cfg, f) for f in REF_FIELDS})
    jfn = jm.make_objective(
        *jm.apply_morton(np.asarray(obs), z_obs.numpy(), 2), jcfg
    )[0]
    got = {}
    for name, a, nu11, nu22, beta in (
        ("exact_end", 0.128317, 0.407752, 0.960064, 0.491961),
        ("tlr_end", 2.23856, 0.324723, 0.724248, 0.490133),
    ):
        x = tm.pack_params(
            tc.MaternParams.bivariate(
                a=a, nu11=nu11, nu22=nu22, beta=beta, device="cpu"
            ),
            True,
        )
        got[name] = -float(fn(x))
        want = -float(jfn(jnp.asarray(x.numpy())))
        assert got[name] == pytest.approx(want, rel=1e-10)
    assert got["exact_end"] > got["tlr_end"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-780m"])
def test_serve_lm_main_serves_the_tokens_of_generate(arch):
    """The LM serving example (examples/torch/serve_lm.py) at a reduced
    config on the CPU: the sliding-window MoE model and the attention-free
    SSM.  Its prefill and decode loop give, token for token, what
    ``generate`` gives for the same model and prompts (whose parity with
    the reference's is held in tests/test_torch_moe.py and
    tests/test_torch_recurrent.py)."""
    from repro_torch.serving.engine import generate

    ex = _example("serve_lm")
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "16"]
    got = ex.main(argv + ["--steps", "6"])
    cfg, model, prompts = ex.build(arch, 2, 16, 0, "cpu")
    assert got["arch"] == cfg.name and torch.equal(got["prompts"], prompts)
    assert got["tokens"].shape == (2, 6)
    assert torch.equal(got["tokens"], generate(model, cfg, prompts, 6))
    assert got["decode_s_per_token"] > 0


def test_train_lm_main_trains_and_checkpoints(tmp_path):
    """The LM training example (examples/torch/train_lm.py) for a few steps
    on the CPU: its first logged loss is the loss of a fresh model of the
    same seed on the data of step 0, every logged loss and gradient norm is
    finite, and the run ends with its checkpoint (whose train step is held
    against the reference in tests/test_torch_training.py)."""
    from repro_torch.checkpointing.checkpoint import latest_step
    from repro_torch.configs import get_arch
    from repro_torch.dataio.tokens import SyntheticTokens
    from repro_torch.models import init_model
    from repro_torch.training.train_step import TrainConfig, loss_fn

    ex = _example("train_lm")
    ckpt = str(tmp_path / "ckpt")
    got = ex.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", ckpt])
    assert got["final_step"] == 3 and latest_step(ckpt) == 3
    assert [m["step"] for m in got["log"]] == [0]
    cfg = get_arch("qwen3-4b").reduced()
    model = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticTokens(cfg.vocab_size, got["seq"], got["batch"], seed=0).batch(0)
    tcfg = TrainConfig(attn_impl="chunked")
    with torch.no_grad():
        want = float(loss_fn(model, cfg, batch, tcfg)[0])
    assert got["log"][0]["loss"] == want
    assert all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in got["log"])

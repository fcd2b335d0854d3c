"""The port's launch tooling on the CPU: the configs and cells
(repro_torch.configs), the roofline's pure functions (launch/roofline.py),
the dry-run (launch/dryrun.py) and its summary, and the kernels as
traceable operators (kernels/ops.py).

* The configs, ``iter_cells()`` and ``input_specs`` of all 48 cells equal
  the reference's; the roofline's model functions equal
  ``repro.launch.roofline``'s for all twelve archs and their shapes.
* A dry-run of reduced cells (an LM prefill, decode and train step; the
  geostat exact loglik and the TLR pipeline) traced on fake tensors counts
  the FLOPs, bytes and peak of a real run of the same cell on a one-rank
  CPU process group, exactly; a TLR cell on a fake 4-rank mesh reports
  every phase.  (Its collectives against a real 4-rank run are held in
  tests/test_torch_mesh.py and tests/test_torch_lm_mesh.py, whose spawns
  run the same cells.)
* The port traces every layer, so the full-depth count equals the
  reference's two-point extrapolation (``cost_extrapolated``) from one and
  two pattern periods: the identity that makes the extrapolation needless.
* Each custom operator's fake implementation and FLOP formula on fake CUDA
  tensors (no card: none launches).

Each fake process group is made and destroyed inside one ``run_cell``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.configs import iter_cells as j_iter_cells  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.configs import LM_ARCH_NAMES, get_arch, get_shape, iter_cells  # noqa: E402
from repro_torch.configs.base import GeoStatShape, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import summarize  # noqa: E402

ARCH_NAMES = list(dict.fromkeys(a.name for a, _, _ in iter_cells()))


def _reference_input_specs():
    """``repro.launch.dryrun.input_specs``: the module sets XLA_FLAGS for 512
    host devices at import, so this worker's JAX backend is started first
    (the flag then changes nothing) and the variable is restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import input_specs
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return input_specs


# ---------------------------------------------------------------------------
# configs and cells
# ---------------------------------------------------------------------------


def test_configs_cells_and_input_specs_equal_the_reference():
    got = [(a.name, s.name, ok) for a, s, ok in iter_cells()]
    want = [(a.name, s.name, ok) for a, s, ok in j_iter_cells()]
    assert got == want
    assert len(got) == 48 and sum(ok for _, _, ok in got) == 41
    long = sorted(a for a, s, ok in got if s == "long_500k" and ok)
    assert long == ["mamba2-780m", "mixtral-8x7b", "recurrentgemma-9b"]
    assert LM_ARCH_NAMES == [n for n in ARCH_NAMES if not n.startswith("geostat")]
    j_specs = _reference_input_specs()
    for arch, shape, _ in got:
        a, b = get_arch(arch), j_get_arch(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(get_shape(a, shape)) == dataclasses.asdict(
            j_get_shape(b, shape))
        mine = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in dr.input_specs(arch, shape).items()}
        theirs = {k: (tuple(v.shape), str(v.dtype))
                  for k, v in j_specs(arch, shape).items()}
        assert mine == theirs, (arch, shape)
    geo = get_arch("geostat-tlr")
    assert dataclasses.asdict(geo.reduced()) == dataclasses.asdict(
        j_get_arch("geostat-tlr").reduced())


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_roofline_model_functions_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    shapes = [get_shape(cfg, s) for s in cfg.shapes]
    if cfg.family != "geostat":
        assert rl.lm_param_counts(cfg) == jrl.lm_param_counts(jcfg)
        for s in shapes:
            assert rl.lm_model_flops(cfg, s) == jrl.lm_model_flops(jcfg, s)
        return
    for s in shapes:
        assert rl.geostat_model_flops(s, cfg.backend, cfg.tile_size, cfg.max_rank) == \
            jrl.geostat_model_flops(s, jcfg.backend, jcfg.tile_size, jcfg.max_rank)
        t = s.matrix_dim // cfg.tile_size
        for shards in (1, 256, 512):
            assert rl.tlr_pair_update_stats(t, cfg.super_panels, shards) == \
                jrl.tlr_pair_update_stats(t, jcfg.super_panels, shards)
            assert rl.tlr_recompress_temp_model(t, cfg.tile_size, cfg.max_rank, shards) \
                == jrl.tlr_recompress_temp_model(t, cfg.tile_size, cfg.max_rank, shards)
            assert rl.tlr_compress_temp_model(
                t, cfg.tile_size, cfg.max_rank, n_shards=shards
            ) == jrl.tlr_compress_temp_model(t, cfg.tile_size, cfg.max_rank,
                                             n_shards=shards)


def test_roofline_terms_use_the_h100_constants_and_each_axis_link():
    by_axis = {
        "model": dict(bytes=450e9, calls=1, ranks=8, link_bw=rl.link_bw(range(8))),
        "data": dict(bytes=50e9, calls=1, ranks=16, link_bw=rl.link_bw(range(0, 256, 16))),
    }
    counts = dict(flops=989e12, bytes=3.35e12,
                  collectives=dict(by_kind={"all_reduce": 500e9}, by_axis=by_axis))
    r = rl.analyze("a", "s", "pod", 256, counts, 989e12 * 256, compute_dtype="bfloat16")
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.0)
    assert r.dominant == "collective" and r.useful_flops_ratio == 1.0
    assert rl.link_bw(range(16)) == rl.NODE_BW  # a "model" group of (16, 16)
    assert rl.peak_flops("float32") == 67e12 and rl.peak_flops("float64") == 67e12


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

QWEN = get_arch("qwen3-4b").reduced()
CELLS = {
    "prefill": ("qwen3-4b", QWEN, ShapeConfig("prefill", 16, 4, "prefill")),
    "decode": ("qwen3-4b", QWEN, ShapeConfig("decode", 16, 4, "decode")),
    "train": ("qwen3-4b", QWEN, ShapeConfig("train", 16, 4, "train")),
    "exact": ("geostat-exact", get_arch("geostat-exact").reduced(),
              GeoStatShape("exact", 256, 2, "mle")),
    "tlr": ("geostat-tlr", get_arch("geostat-tlr").reduced(),
            GeoStatShape("tlr", 256, 2, "mle")),
}


def _run(key, out_dir=None, **kw):
    arch, cfg, shape = CELLS[key]
    return dr.run_cell(arch, shape.name, "pod", out_dir=out_dir, device="cpu", cfg=cfg,
                       shape=shape, **kw)


@pytest.mark.parametrize("key", list(CELLS))
def test_fake_trace_counts_a_real_run_at_one_rank(key):
    """FLOPs (FlopCounterMode), dispatched bytes and the peak live bytes of
    the fake trace equal the real run's on a one-rank CPU process group."""
    fake = _run(key, world=(1, 1), correct_costs=False)
    real = _run(key, world=(1, 1), correct_costs=False, fake=False)
    assert fake["fake"] and not real["fake"]
    assert fake["hlo_flops_per_chip"] == real["hlo_flops_per_chip"] > 0
    assert fake["hlo_bytes_per_chip"] == real["hlo_bytes_per_chip"] > 0
    assert fake["peak_bytes"] == real["peak_bytes"] > 0
    assert fake["collectives"] == real["collectives"]
    assert fake["cost_correction"] == "none (every layer traced)"


def test_tlr_cell_on_a_fake_four_rank_mesh_reports_every_phase(tmp_path):
    rec = _run("tlr", world=(2, 2), out_dir=str(tmp_path))
    phases = rec["tlr_phases"]
    for name in ("gen", "gen_compress", "gen_compress_sharded", "gen_compress_mixed_f32",
                 "factorize_masked", "factorize_bc", "factorize_bc_repl", "serve_fit",
                 "serve_predict"):
        assert phases[name]["temp_bytes"] > 0 and phases[name]["trace_s"] >= 0, name
    assert phases["factorize"] == phases["factorize_bc"]
    assert phases["compress"] == phases["gen_compress_sharded"]
    # each rank compresses its own slots: less than the replicated batch
    assert phases["gen_compress_sharded"]["temp_bytes"] < \
        phases["gen_compress"]["temp_bytes"]
    assert phases["serve_predict"]["predictions_per_sec"] > 0
    assert phases["pair_stats"] == rl.tlr_pair_update_stats(8, 1, 4)
    assert rec["collective_breakdown"]["by_axis"]["data+model"] > 0
    assert rec["fits"] and rec["status"] == "ok"
    table = summarize.markdown_table(summarize.load_records(str(tmp_path)), None)
    assert "| geostat-tlr | tlr | pod |" in table


def test_summary_names_a_cell_that_failed(tmp_path):
    rec = dict(arch="llama4", shape="train_4k", mesh="pod", status="failed",
               error="ValueError('16 model-parallel ranks do not divide 40 heads')")
    table = summarize.markdown_table([rec], "pod")
    assert "failed: ValueError" in table and "40 heads" in table


@pytest.mark.parametrize("arch,depths", [("qwen3-4b", (1, 2, 5)),
                                         ("recurrentgemma-9b", (3, 6, 9))])
def test_every_layer_traced_equals_the_two_point_extrapolation(arch, depths):
    """The reference's ``cost_extrapolated``: per_block = c(2) - c(1),
    outside = c(1) - per_block, total = outside + per_block * (blocks +
    tail / period), from traces at one and two pattern periods, equals the
    port's trace at full depth, which counts every layer."""
    base = get_arch(arch).reduced()
    shape = ShapeConfig("prefill", 16, 4, "prefill")
    counts = {}
    for n in depths:
        cfg = dataclasses.replace(base, num_layers=n)
        rec = dr.run_cell(arch, "prefill", "pod", out_dir=None, device="cpu",
                          world=(2, 2), cfg=cfg, shape=shape)
        counts[n] = np.array([rec["hlo_flops_per_chip"], rec["hlo_bytes_per_chip"],
                              rec["collective_bytes_per_chip"]])
    period = base.pattern_period
    one, two, full = (counts[n] for n in depths)
    per_block = two - one
    outside = one - per_block
    blocks, tail = divmod(depths[2], period)
    np.testing.assert_array_equal(outside + per_block * (blocks + tail / period), full)


# ---------------------------------------------------------------------------
# the kernels as operators
# ---------------------------------------------------------------------------


def test_kernel_ops_trace_on_fake_cuda_tensors_with_their_flop_formulas():
    """Each ``repro_torch::`` op on fake CUDA tensors runs its fake
    implementation (the output's shape, dtype and device; no launch) and
    FlopCounterMode counts its formula."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with FakeTensorMode():
        a = torch.empty(2, 64, 64, device="cuda")
        u = torch.empty(2, 64, 16, device="cuda")
        q = torch.empty(8, 128, 64, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 128, 64, device="cuda", dtype=torch.bfloat16)
        la = torch.empty(100, 2, device="cuda")
        lb = torch.empty(50, 2, device="cuda")
        cases = [
            (lambda: ops.potrf(a), (2, 64, 64), 2 * 64**3 // 3),
            (lambda: ops.trsm(a, a), (2, 64, 64), 2 * 64 * 64 * 64),
            (lambda: ops.syrk(a, u), (2, 64, 64), 2 * 64 * 65 * 16),
            (lambda: ops.tlr_mm(u, u, u, u, a), (2, 64, 64),
             2 * 2 * (2 * 64 * 16 * 16 + 64 * 64 * 16)),
            (lambda: ops.tlr_mm(u, u, u, u, a, out=a), (2, 64, 64),
             2 * 2 * (2 * 64 * 16 * 16 + 64 * 64 * 16)),
            (lambda: torch.ops.repro_torch.flash_attention(q, k, k, True, 0, None),
             (8, 128, 64), 4 * 64 * ops.attention_pairs(128, 128, 0) * 8),
            (lambda: ops.matern_tile(la, lb, 11.0, 1.0, nu=1.5), (100, 50), 100 * 50 * 12),
            (lambda: ops.matern_correlation(a, 2.5), (2, 64, 64), 2 * 64 * 64 * 9),
        ]
        for call, shape, flops in cases:
            with FlopCounterMode(display=False) as fc:
                out = call()
            assert tuple(out.shape) == shape and out.device.type == "cuda"
            assert fc.get_total_flops() == flops
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b"])
def test_moe_at_capacity_gives_the_dispatch_values(arch):
    """``settings.moe_at_capacity`` (the dry-run's static-shape dispatch:
    each expert computes its whole capacity buffer) gives the logits and
    aux loss of the real dispatch, with drops (the config's capacity
    factor) and dropless."""
    from repro_torch.models import forward, init_model, settings

    cfg = get_arch(arch).reduced()
    model = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    for dropless in (False, True):
        with torch.no_grad():
            want = forward(model, cfg, tokens, dropless=dropless)
            with settings.moe_at_capacity():
                got = forward(model, cfg, tokens, dropless=dropless)
        np.testing.assert_allclose(got.logits, want.logits, rtol=1e-5, atol=1e-5)
        assert float(got.aux_loss) == float(want.aux_loss)

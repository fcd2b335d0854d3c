"""The port's LM multi-device forms on a torch.distributed mesh
(repro_torch.models.shardspecs, distribution/sharding.py, the sharded
forward and train step, compression's collective form, elastic restore,
launch/train.py) on the CPU over gloo.

One spawn of 4 ranks on a (2, 2) ("data", "model") mesh; each rank also
builds a (2, 1, 2) ("pod", "data", "model") and a (4, 1) mesh over the same
ranks and runs every case of tests/torch_lm_mesh_ranks.py once.  The
reduced configs run in float32 with the reference's ``init_model`` weights
(``convert.lm_params_from_numpy``).  The reference's own mesh forms do not
run under this JAX (ROADMAP Queue 3), and by its contract they compute
what its mesh=None forms compute, but for one change of numbers by design:
MoE dispatch is shard-local over the data-parallel axes, with a global aux
loss.  So each case is held against the reference's mesh=None form (the
forward of each data-parallel block of rows alone, the aux loss of the
whole batch) at the tolerances of tests/test_torch_lm.py (1e-4 of the
largest logit) and tests/test_torch_training.py (1e-5), and against the
port's own single-device form.  The MoE train steps raise the capacity
factor to E / k, so no pair is dropped and the shard-local dispatch equals
the reference's global one; the forward keeps the configs' factor, where
pairs are dropped.
"""

import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_mesh_ranks as R  # noqa: E402
from repro.configs import LM_ARCH_NAMES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.distribution import compression as jcomp  # noqa: E402
from repro.distribution.sharding import param_specs as j_param_specs  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import block_spec  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_leaves_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.distribution import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.training.optimizer import opt_state_specs  # noqa: E402

WORLD = 4
# arch: (config overrides of every case, of the train steps only).  llama4
# gets 16 experts, so PRODUCTION_TP divides them and they lie over "model"
# (EP); mamba2 a vocabulary of 250, which it does not divide (the rule of
# its 50280: the embedding shards d_model); the MoE train steps a capacity
# factor of E / k (no drops).
ARCHS = {
    "qwen3-4b": ({}, {}),
    "mixtral-8x7b": ({}, {"capacity_factor": 2.0}),
    "llama4-maverick-400b-a17b": ({"num_experts": 16}, {"capacity_factor": 16.0}),
    "mamba2-780m": ({"vocab_size": 250}, {}),
    "recurrentgemma-9b": ({}, {}),
}
FORWARD = (
    ("qwen3-4b", "kernel"),
    ("mixtral-8x7b", "naive"),
    ("llama4-maverick-400b-a17b", "naive"),
    ("mamba2-780m", "naive"),
    ("recurrentgemma-9b", "chunked"),
)
FORWARD_POD = ("qwen3-4b", "mixtral-8x7b")
TRAIN_KEYS = tuple(ARCHS) + ("microbatches", "pod", "compress")
REF_TOL, OWN_TOL, TOL = 1e-4, 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(arch, *overrides):
    cfg = j_get_arch(arch).reduced()
    for o in overrides:
        cfg = dataclasses.replace(cfg, **o)
    return cfg


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@functools.cache
def _weights(arch):
    """(reference params, the port's state by name as numpy)."""
    overrides = ARCHS[arch][0]
    params = j_init_model(jax.random.PRNGKey(1), _jcfg(arch, overrides))
    model = lm_params_from_numpy(_np(params), R.config(arch, overrides), device="cpu")
    return params, {n: p.detach().numpy() for n, p in model.named_parameters()}


def _reference_forward(arch):
    """The reference's mesh=None logits of each data-parallel block of rows
    alone (its shard-local MoE dispatch) and its aux loss of the whole batch."""
    overrides = ARCHS[arch][0]
    jcfg, params = _jcfg(arch, overrides), _weights(arch)[0]
    tokens = R.forward_tokens(R.config(arch, overrides))
    run = jax.jit(lambda p, t: j_forward(p, jcfg, tokens=t))
    half = len(tokens) // 2
    blocks = [run(params, jnp.asarray(tokens[i : i + half])) for i in (0, half)]
    return dict(
        logits=np.concatenate([np.asarray(b.logits) for b in blocks]),
        aux=float(run(params, jnp.asarray(tokens)).aux_loss),
    )


def _reference_moe(arch):
    """The reference's moe_block of the first MoE layer on ``moe_input``:
    y of each data-parallel block alone, the aux loss of the whole batch,
    and how many (token, choice) pairs the blocks' capacity drops."""
    from repro.models.moe import _capacity, moe_block

    overrides = ARCHS[arch][0]
    jcfg, params = _jcfg(arch, overrides), _weights(arch)[0]
    pos = next(i for i, (_, moe) in enumerate(block_spec(jcfg)) if moe)
    mp = jax.tree.map(lambda a: a[0], params["blocks"][pos]["moe"])
    x = R.moe_input(R.config(arch, overrides))
    run = jax.jit(lambda p, v: moe_block(p, v, jcfg))
    half = len(x) // 2
    ys = [run(mp, jnp.asarray(x[i : i + half]))[0] for i in (0, half)]
    # pairs past an expert's capacity within a block (the router's top-k)
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) @ mp.router
    idx = np.asarray(jax.lax.top_k(jax.nn.softmax(logits), jcfg.experts_per_token)[1])
    t = half * x.shape[1]
    e = jcfg.num_experts
    cap = _capacity(t, jcfg.experts_per_token, e, jcfg.capacity_factor)
    dropped = sum(
        int(np.maximum(np.bincount(b.ravel(), minlength=e) - cap, 0).sum())
        for b in (idx[:t], idx[t:])
    )
    return dict(
        y=np.concatenate([np.asarray(y) for y in ys]),
        aux=float(run(mp, jnp.asarray(x))[1]),
        dropped=dropped,
    )


def _reference_train(arch, extra, **tkw):
    """Three reference steps (``tkw``: more of its TrainConfig): each
    step's metrics and the final master copy as the port's parameters by
    name.  With ``compress_cross_pod`` the errors carry from step to step."""
    overrides = ARCHS[arch][0]
    jcfg = _jcfg(arch, overrides, extra)
    params = _weights(arch)[0]
    jtc = jts.TrainConfig(remat=True, **tkw)
    step = jax.jit(lambda p, o, e, b: jts.train_step(p, o, e, b, cfg=jcfg, tcfg=jtc))
    opt, errors, metrics = jopt.adamw_init(params), None, []
    cfg = R.config(arch, {**overrides, **extra})
    for b in R.train_batches(cfg):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        params, opt, errors, m = step(params, opt, errors, b)
        metrics.append({k: float(v) for k, v in m.items()})
    master = lm_leaves_from_numpy(_np(opt.master), cfg, device="cpu")
    names = [n for n, _ in init_model(cfg, device="cpu").named_parameters()]
    return dict(metrics=metrics, params=dict(zip(names, master)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn runs while the references and the port's single-device
    forms are computed here."""
    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    archs = {a: (ARCHS[a][0], _weights(a)[1]) for a in ARCHS}
    payload = dict(
        archs=archs,
        forward=FORWARD,
        forward_pod=FORWARD_POD,
        train=[(a, ARCHS[a][1]) for a in ARCHS],
        tmp=tmp,
    )
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(
            lm.spawn_ranks, R.run_all, WORLD, args=(payload,), device_type="cpu",
            timeout_s=300.0,
        )
        ref = {"forward": {a: _reference_forward(a) for a, _ in FORWARD}, "train": {}}
        ref["moe"] = {a: _reference_moe(a) for a in ARCHS if j_get_arch(a).moe}
        for a in ARCHS:
            ref["train"][a] = _reference_train(a, ARCHS[a][1])
        ref["train"]["compress"] = _reference_train(
            "qwen3-4b", {}, compress_cross_pod=True
        )
        own = {"forward": {}, "train": {}}
        for a, impl in FORWARD:
            own["forward"][a] = lm.to_host(R.run_forward(None, R.config(a, ARCHS[a][0]),
                                                         archs[a][1], impl))
        qwen = "qwen3-4b"
        cfg = R.config(qwen, {})
        for key, kw in (("microbatches", dict(microbatches=2)),
                        ("compress", dict(compress_cross_pod=True))):
            own["train"][key] = lm.to_host(R.run_train(None, cfg, archs[qwen][1], kw))
        own["trainer"] = lm.to_host(R.run_trainer(cfg, archs[qwen][1], tmp + "/own"))
        ranks = future.result()
    return dict(ref=ref, own=own, ranks=ranks)


def _ranks(runs):
    return runs["ranks"]


# ---------------------------------------------------------------------------
# specs (no ranks)
# ---------------------------------------------------------------------------


def _field(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _reference_specs_by_name(jspecs, model, cfg) -> dict:
    """The reference's spec tree as specs of the port's parameters by name:
    the blocks' stacked leading None dropped, an ``nn.Linear``'s (out, in)
    weight given the reference's (in, out) spec reversed, each spec padded
    with None to its parameter's rank."""
    from repro_torch.models.transformer import layer_counts

    def spec(p, n):
        entries = tuple(p) + (None,) * (n - len(tuple(p)))
        return entries

    out = {}
    nblocks = layer_counts(cfg)[0]
    period = len(cfg.layer_pattern)
    for i, layer in enumerate(model.layers):
        if i < nblocks * period:
            src, stacked = jspecs["blocks"][i % period], True
        else:
            src, stacked = jspecs["tail"][i - nblocks * period], False
        for name, p in layer.named_parameters():
            parts = name.split(".")
            owner = layer.get_submodule(".".join(parts[:-1]))
            linear = isinstance(owner, torch.nn.Linear)
            node = src
            for part in parts[:-1] if linear else parts:
                node = _field(node, part)
            entries = tuple(node)[1:] if stacked else tuple(node)
            got = spec(entries, p.dim())
            out[f"layers.{i}.{name}"] = got[::-1] if linear else got
    out["final_norm"] = spec(tuple(jspecs["final_norm"]), 1)
    out["embed"] = spec(tuple(jspecs["embed"]), 2)
    if "lm_head" in jspecs:
        out["lm_head.weight"] = spec(tuple(jspecs["lm_head"]), 2)[::-1]
    return out


@pytest.mark.parametrize("arch", LM_ARCH_NAMES)
def test_param_and_opt_state_specs_equal_the_reference(arch):
    """param_specs and opt_state_specs against the reference's for every
    arch, at the reduced shapes with the full config's vocabulary and
    expert count (what the vocab and EP rules read)."""
    full = j_get_arch(arch)
    over = dict(vocab_size=full.vocab_size, num_experts=full.reduced().num_experts)
    if full.moe:
        over["num_experts"] = full.num_experts
    jcfg = _jcfg(arch, over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    model = init_model(
        dataclasses.replace(cfg, vocab_size=16, d_ff=16),  # names only
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    jspecs = j_param_specs(jcfg)
    want = _reference_specs_by_name(jspecs, model, cfg)
    got = sh.param_specs(cfg)
    assert got == want
    names = [n for n, _ in model.named_parameters()]
    assert list(got) != [] and set(got) == set(names)
    ordered = [got[n] for n in names]
    opt = opt_state_specs(ordered)
    jopt_specs = jopt.opt_state_specs(jspecs)
    assert opt.step == tuple(jopt_specs.step) == ()
    assert opt.master == opt.m == opt.v == ordered
    assert _reference_specs_by_name(jopt_specs.m, model, cfg) == want


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def test_batch_specs_and_constrain_match_the_reference(runs):
    """batch_axes and data_specs (tokens, targets; embeds) against the
    reference's on the (2, 2) and the pod mesh's axis names; constrain
    gives each rank its block of a ("data", "model") spec, and
    unshard_tensor the whole tensor back."""
    from types import SimpleNamespace

    from repro.distribution import sharding as jsh

    jcfg = _jcfg("qwen3-4b")
    names = {"2x2": ("data", "model"), "pod": ("pod", "data", "model")}
    x = np.arange(32.0).reshape(4, 8)
    for r in _ranks(runs):
        api = r["api"]
        for key, axes in names.items():
            fake = SimpleNamespace(axis_names=axes)
            assert api[key]["batch_axes"] == jsh.batch_axes(fake)
            for kind, embeds, field in (
                ("train", False, "train"), ("prefill", True, "prefill_embeds")
            ):
                want = jsh.data_specs(jcfg, fake, kind, embeds)
                assert api[key][field] == {k: tuple(v) for k, v in want.items()}
        d, m = api["coordinate"]
        block = x[2 * d : 2 * d + 2, 4 * m : 4 * m + 4]
        np.testing.assert_array_equal(api["local"], block)
        assert api["whole_again"]


def test_autograd_collectives_match_one_process(runs):
    """copy_to_region, reduce_from_region and gather_dim (reduce-scatter
    and slice backward, over a built two-axis group and over "model"):
    value and gradient against the same objective computed whole, on every
    rank, at 1e-12 (float64)."""
    for r in _ranks(runs):
        for name, gap in r["collectives"].items():
            assert gap <= 1e-12, (r["rank"], name, gap)


@pytest.mark.parametrize(
    "case", [a for a, _ in FORWARD] + [a + "@pod" for a in FORWARD_POD]
)
def test_sharded_forward_matches_the_reference(runs, case):
    """The sharded forward (FSDP gather, TP attention and MLP, vocab-parallel
    embedding and head; MoE EP or TP inside the experts with shard-local
    dispatch; ssd and rglru gathered whole) on (2, 2), and on the pod mesh:
    each rank's rows' logits against the reference's mesh=None forward of
    its data-parallel block alone (REF_TOL) and the port's own (OWN_TOL);
    the aux loss the same on every rank (a global one)."""
    arch = case.split("@")[0]
    ref, own = runs["ref"]["forward"][arch], runs["own"]["forward"][arch]
    for r in _ranks(runs):
        got = r["forward"][case]
        rows = got["rows"]
        assert _rel(got["logits"], ref["logits"][rows]) <= REF_TOL
        assert _rel(got["logits"], own["logits"][rows]) <= OWN_TOL
        assert got["aux"] == _ranks(runs)[0]["forward"][case]["aux"]


@pytest.mark.parametrize("arch", [a for a in ARCHS if j_get_arch(a).moe])
def test_sharded_moe_block_dispatches_shard_locally_with_a_global_aux(runs, arch):
    """The first MoE layer's block on (2, 2) (mixtral: TP inside each
    expert; llama4 at 16 experts: EP), on an input where capacity drops
    pairs: each rank's y against the reference's moe_block on its
    data-parallel block alone (the shard-local dispatch), the aux loss
    against the reference's on the whole batch (global density and router
    means), at 1e-5."""
    ref = runs["ref"]["moe"][arch]
    assert ref["dropped"] > 0
    for r in _ranks(runs):
        got = r["moe"][arch]
        assert _rel(got["y"], ref["y"][got["rows"]]) <= TOL
        assert got["aux"] == pytest.approx(ref["aux"], rel=TOL)


def _param_gap(got: dict, want: dict, zero_start: dict) -> float:
    """The largest gap of any parameter over its largest magnitude; a leaf
    that starts at 0 (norm scales, biases) taken as 1 + w."""
    worst = 0.0
    for name, w in want.items():
        g, w = np.asarray(got[name], np.float64), np.asarray(w, np.float64)
        if zero_start[name]:
            g, w = g + 1.0, w + 1.0
        worst = max(worst, float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30)))
    return worst


def _off_share(got: dict, want: dict, zero_start: dict) -> float:
    """The largest share, over the parameters, of a parameter's elements
    off by more than TOL of its largest magnitude (``_param_gap``'s
    measure, element by element)."""
    worst = 0.0
    for name, w in want.items():
        g, w = np.asarray(got[name], np.float64), np.asarray(w, np.float64)
        if zero_start[name]:
            g, w = g + 1.0, w + 1.0
        off = np.abs(g - w) > TOL * max(np.max(np.abs(w)), 1e-30)
        worst = max(worst, float(off.mean()))
    return worst


@pytest.mark.parametrize("key", TRAIN_KEYS)
def test_three_sharded_train_steps_match_the_reference(runs, key):
    """Three steps of make_train_step(cfg, mesh) on (2, 2) for the five
    families, with microbatches=2 and on the pod mesh for qwen3-4b: every
    step's loss and gradient norm on every rank, and the gathered final
    parameters, against the reference's mesh=None steps at 1e-5; with
    compress_cross_pod on the pod mesh (each leaf quantised where its shard
    is a run of whole blocks, gathered otherwise; the errors carried from
    step to step) against the reference's mesh=None compressed steps, and
    with microbatches or compression also against the port's own
    single-device steps, at 1e-5.  Compression rounds each element to a
    whole quantum, so an element whose gradient lies within float rounding
    of a half quantum may round the other way on the mesh, where the sums
    run in another order, and AdamW moves it by up to lr apart: there the
    parameters are held by the share of each leaf's elements off by more
    than 1e-5 of its magnitude, at most 1e-3, as
    tests/test_torch_training.py holds its fast steps (measured here: one
    element of a leaf of 32768, 3e-5)."""
    arch = key if key in ARCHS else "qwen3-4b"
    want = runs["ref"]["train"].get(key, runs["ref"]["train"][arch])
    state = _weights(arch)[1]
    zero = {n: not np.any(v) for n, v in state.items()}
    for r in _ranks(runs):
        got = r["train"][key]
        for g, w in zip(got["metrics"], want["metrics"], strict=True):
            for k in ("loss", "grad_norm", "lr"):
                assert g[k] == pytest.approx(w[k], rel=TOL), k
    got = _ranks(runs)[0]["train"][key]["params"]
    wants = [want["params"]]
    if key in ("microbatches", "compress"):
        wants.append(runs["own"]["train"][key]["params"])
    for w in wants:
        if key == "compress":
            assert _off_share(got, w, zero) <= 1e-3
        else:
            assert _param_gap(got, w, zero) <= TOL
    if key == "compress":  # both forms of a shard: in place and gathered
        for r in _ranks(runs):
            assert r["train"][key]["in_place"] > 0 and r["train"][key]["gathered"] > 0


def test_compressed_psum_matches_the_reference_composed_over_pods(runs):
    """compressed_psum over the pod mesh's "pod" axis, two steps with error
    feedback: the mean and each pod's error against the reference's
    _quantize / _dequantize composed over the two pods as its
    compressed_psum_leaf does."""
    shapes = [(16, 32), (7, 5), (300,)]
    errors = [[jnp.zeros(s, jnp.float32) for s in shapes] for _ in range(2)]
    for step in range(2):
        rngs = [np.random.default_rng(50 + 10 * step + p) for p in range(2)]
        grads = [
            [rng.standard_normal(s).astype(np.float32) for s in shapes] for rng in rngs
        ]
        means, new_errors = [], [[], []]
        for i, s in enumerate(shapes):
            gf = [jnp.asarray(grads[p][i]) + errors[p][i] for p in range(2)]
            qs = [jcomp._quantize(g) for g in gf]
            qsum = sum(q.astype(jnp.int32) for q, _ in qs)
            ssum = sum(sc for _, sc in qs)
            means.append(np.asarray(jcomp._dequantize(qsum, ssum / 2, s) / 2))
            for p in range(2):
                new_errors[p].append(gf[p] - jcomp._dequantize(qs[p][0], qs[p][1], s))
        errors = new_errors
        for r in _ranks(runs):
            got = r["compressed_psum"]
            rec = got["steps"][step]
            for g, w in zip(rec["means"], means, strict=True):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            for g, w in zip(rec["errors"], errors[got["pod"]], strict=True):
                np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "case", ["one_to_2x2", "2x2_to_4x1", "2x2_to_one", "4x1_to_2x2"]
)
def test_elastic_restore_is_bit_for_bit(runs, case):
    """A trainer state (AdamW master, moments, step; compression errors)
    saved whole from one device restores onto (2, 2); saved from (2, 2)
    (gathered, rank 0 writes) onto (4, 1) and onto one device; saved from
    (4, 1) onto (2, 2): every leaf on every rank equals its shard of the
    whole state exactly."""
    for r in _ranks(runs):
        assert r["restore"][case] is True


def test_trainer_resumes_on_another_mesh_shape(runs):
    """The fault-tolerant Trainer runs 4 steps on (2, 2) with a checkpoint
    every 2, then a new Trainer on (4, 1) resumes from step 4 and runs to 6:
    its whole final checkpoint's master against the same two runs on one
    device (1e-5 of each leaf)."""
    own = runs["own"]["trainer"]
    got = _ranks(runs)[0]["trainer"]
    assert got["step"] == own["step"] == 6 and got["resumed_at"] == 6
    for g, w in zip(got["master"], own["master"], strict=True):
        assert _rel(g + 1.0, w + 1.0) <= TOL


def test_an_indivisible_batch_is_refused(runs):
    """A batch of 3 rows over the two data-parallel ranks of (2, 2) is
    refused: each rank dispatches its own rows, which the reference does
    only where the DP size divides the tokens (a difference by design,
    ROADMAP Queue 3)."""
    for r in _ranks(runs):
        assert "does not divide" in r["refused"]


def test_launcher_trains_on_the_mesh(runs):
    """launch/train.py's rank body: two compressed steps of the reduced
    qwen3-4b on the (2, 2) mesh, through the Trainer and its checkpoints."""
    for r in _ranks(runs):
        out = r["launcher"]
        assert out["mesh"] == {"data": 2, "model": 2}
        assert out["final_step"] == 2 and out["nan_restores"] == 0

"""The port's LM training (repro_torch.training, dataio, the compression
simulation, ``forward(remat=True)``) against the JAX reference on the CPU.

The reduced qwen3-4b (2 layers, d 128, f32) takes the reference's
``init_model`` weights (``convert.lm_params_from_numpy``); gradients and
optimizer states come back through ``convert.lm_leaves_from_numpy`` and
``convert.adamw_state_from_numpy``.  Gradient and parameter gaps are
measured leaf by leaf, relative to the leaf's largest magnitude.

Parameters are compared after three steps at the default ``AdamWConfig``
(learning rate 3e-6, 6e-6, 9e-6 over the warm-up), a norm scale w as the
1 + w that the model multiplies by: AdamW's update
m / (sqrt(v) + eps) turns an f32 rounding difference of a small gradient
element into an absolute step error of order lr, whatever the
implementation (at lr 1e-2 the two packages' parameters differ by 8.9e-4
of a leaf's largest magnitude after three steps, with their gradients
within 2.5e-6).  The optimizer's arithmetic itself is held on the same
inputs at 1e-6.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LM_ARCH_NAMES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.dataio import tokens as jtok  # noqa: E402
from repro.distribution import compression as jcomp  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro.training.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpointing.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adamw_state_from_numpy,
    lm_leaves_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.dataio import tokens as ttok  # noqa: E402
from repro_torch.distribution import compression as tcomp  # noqa: E402
from repro_torch.models import forward, init_model  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig,
    grads_fn,
    loss_fn,
    make_train_step,
    train_step,
)
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "qwen3-4b"
TOL = 1e-5
# the reference's trainer tests' optimizer (tests/test_training_substrate.py)
FAST = topt.AdamWConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=50)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_gap(got, want) -> float:
    """The largest gap of any leaf over that leaf's largest magnitude."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.detach().float(), w.detach().float()
        scale = float(w.abs().max())
        worst = max(worst, float((g - w).abs().max()) / (scale if scale else 1.0))
    return worst


def _param_gap(model, want) -> float:
    """``_leaf_gap`` of the model's parameters against ``want`` (tensors in
    parameter order), a norm scale w taken as the 1 + w that ``rms_norm``
    multiplies by: its zero start has no magnitude of its own."""
    got, ref = [], []
    for (name, p), w in zip(model.named_parameters(), want, strict=True):
        one = 1.0 if "norm" in name.rsplit(".", 1)[-1] else 0.0
        got.append(p.detach() + one)
        ref.append(w + one)
    return _leaf_gap(got, ref)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.cache
def _setup(arch=ARCH, seed=0):
    """(reference cfg, its params, port cfg, the params as numpy)."""
    jcfg, cfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    params = j_init_model(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, cfg, _np(params)


def _model(arch=ARCH, seed=0):
    _, _, cfg, np_params = _setup(arch, seed)
    return lm_params_from_numpy(np_params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_the_reference():
    jcfg = jopt.AdamWConfig(learning_rate=3e-4, warmup_steps=10, decay_steps=110)
    cfg = topt.AdamWConfig(learning_rate=3e-4, warmup_steps=10, decay_steps=110)
    steps = np.array([0, 1, 5, 10, 60, 109, 110, 500], np.int32)
    want = np.asarray(jopt.lr_schedule(jcfg, jnp.asarray(steps)))
    got = topt.lr_schedule(cfg, torch.as_tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_the_reference(clipped):
    """One update from the same f32 params, grads and mid-run state, each
    leaf within 1e-6 of its largest magnitude; with ``clipped`` the
    gradients' norm is above ``grad_clip_norm``."""
    rng = np.random.default_rng(7)
    shapes = [(64, 32), (32,), (5, 7, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    scale = 3.0 if clipped else 0.01
    grads = [scale * rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [0.01 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    v = [1e-4 * rng.random(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=1e-2, warmup_steps=3, decay_steps=20)
    jstate = jopt.AdamWState(jnp.asarray(4, jnp.int32), params, m, v)
    jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**kw), grads, jstate, params)
    assert (float(jm["grad_norm"]) > 1.0) == clipped

    tparams = [torch.tensor(p) for p in params]
    state = topt.AdamWState(
        torch.tensor(4, dtype=torch.int32),
        [torch.tensor(p) for p in params],
        [torch.tensor(x) for x in m],
        [torch.tensor(x) for x in v],
    )
    grads_t = [torch.tensor(g) for g in grads]
    out, st, met = topt.adamw_update(topt.AdamWConfig(**kw), grads_t, state, tparams)
    assert out is tparams and int(st.step) == 5
    pairs = [(tparams, jp), (st.master, js.master), (st.m, js.m), (st.v, js.v)]
    for got, want in pairs:
        assert _leaf_gap(got, [torch.tensor(np.asarray(w)) for w in want]) <= 1e-6
    for key in ("grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(float(jm[key]), rel=1e-6)


# ---------------------------------------------------------------------------
# grads_fn, train_step
# ---------------------------------------------------------------------------


@functools.cache
def _reference_grads(remat: bool):
    jcfg, params, cfg, _ = _setup()
    batch = ttok.SyntheticTokens(cfg.vocab_size, 16, 8, seed=2).batch(0)
    fn = jax.jit(lambda p, b: jts.grads_fn(p, jcfg, b, jts.TrainConfig(remat=remat)))
    grads, metrics = fn(params, _jbatch(batch))
    return batch, lm_leaves_from_numpy(_np(grads), cfg, device="cpu"), _np(metrics)


@pytest.mark.parametrize("remat", [False, True])
def test_grads_fn_matches_the_reference(remat):
    """Loss and every gradient leaf at 1e-5, with and without remat;
    remat=True against remat=False in the port."""
    batch, want, jm = _reference_grads(remat)
    _, _, cfg, _ = _setup()
    model = _model()
    grads, metrics = grads_fn(model, cfg, batch, TrainConfig(remat=remat))
    assert all(g.dtype == torch.float32 for g in grads)
    assert _leaf_gap(grads, want) <= TOL
    for key in ("loss", "nll", "aux", "tokens"):
        assert float(metrics[key]) == pytest.approx(float(jm[key]), rel=TOL, abs=1e-7)
    other, _ = grads_fn(model, cfg, batch, TrainConfig(remat=not remat))
    assert _leaf_gap(grads, other) <= TOL


def test_microbatch_accumulation_matches_full_batch():
    """microbatches=4 against the reference's single batch at 1e-5, and
    against the port's at the reference's own test's tolerance."""
    batch, want, _ = _reference_grads(False)
    _, _, cfg, _ = _setup()
    model = _model()
    g4, m4 = grads_fn(model, cfg, batch, TrainConfig(remat=False, microbatches=4))
    g1, m1 = grads_fn(model, cfg, batch, TrainConfig(remat=False, microbatches=1))
    assert _leaf_gap(g4, want) <= TOL
    for a, b in zip(g1, g4):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)
    assert float(m4["tokens"]) == float(m1["tokens"]) / 4
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)


def test_three_train_steps_match_the_reference():
    jcfg, params, cfg, _ = _setup()
    jtc = jts.TrainConfig(remat=True)
    step = jax.jit(lambda p, o, e, b: jts.train_step(p, o, e, b, cfg=jcfg, tcfg=jtc))
    jo = jopt.adamw_init(params)
    model = _model()
    opt, errors = topt.adamw_init(model), None
    data = ttok.SyntheticTokens(cfg.vocab_size, 16, 4, seed=4)
    port_step = make_train_step(cfg, None, TrainConfig(remat=True))
    for i in range(3):
        b = data.batch(i)
        params, jo, _, jm = step(params, jo, None, _jbatch(b))
        model, opt, errors, m = port_step(model, opt, errors, b)
        for key in ("loss", "grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=TOL)
    want = adamw_state_from_numpy(_np(jo), cfg, device="cpu")
    assert int(opt.step) == int(want.step) == 3
    assert _param_gap(model, want.master) <= TOL
    assert _leaf_gap(opt.m, want.m) <= TOL


def test_three_fast_train_steps_move_the_parameters_as_the_reference():
    """Each step's parameter deltas at FAST's learning rate (1e-2, where a
    step of the wrong size shows on every leaf).  A few elements whose
    gradient is near rounding move by up to lr apart (module note), so a
    leaf is held by the share of its elements off by more than 1e-2 of its
    largest delta: at most 1e-3 (measured here: 1e-4 at most, norm leaves
    0; the largest element gap 2.6e-2 of a leaf's largest delta)."""
    jcfg, params, cfg, _ = _setup()
    fast = jopt.AdamWConfig(**dataclasses.asdict(FAST))
    jtc = jts.TrainConfig(remat=True, optimizer=fast)
    step = jax.jit(lambda p, o, e, b: jts.train_step(p, o, e, b, cfg=jcfg, tcfg=jtc))
    jo = jopt.adamw_init(params)
    model = _model()
    opt = topt.adamw_init(model)
    data = ttok.SyntheticTokens(cfg.vocab_size, 16, 4, seed=4)
    port_step = make_train_step(cfg, None, TrainConfig(remat=True, optimizer=FAST))
    want = adamw_state_from_numpy(_np(jo), cfg, device="cpu").master
    for i in range(3):
        want_before = want
        got_before = [p.detach().clone() for p in model.parameters()]
        b = data.batch(i)
        params, jo, _, _ = step(params, jo, None, _jbatch(b))
        model, opt, _, _ = port_step(model, opt, None, b)
        want = adamw_state_from_numpy(_np(jo), cfg, device="cpu").master
        for p, g0, w, w0 in zip(model.parameters(), got_before, want, want_before):
            dw = w - w0
            off = (p.detach() - g0 - dw).abs() > 1e-2 * float(dw.abs().max())
            assert float(off.float().mean()) <= 1e-3


def _smoke_batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = dict(tokens=tokens[:, :-1], targets=tokens[:, 1:])
    if cfg.frontend != "none":
        embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch = dict(embeds=embeds, targets=tokens[:, 1:])
    return batch


@pytest.mark.parametrize("arch", LM_ARCH_NAMES)
def test_train_step_smoke_matches_the_reference(arch):
    """tests/test_models_smoke.py::test_train_step_smoke on the port: the
    loss with remat=True against the reference's at 1e-5, finite
    gradients, and a loss that moves after one train step."""
    jcfg, params, cfg, np_params = _setup(arch, 1)
    model = lm_params_from_numpy(np_params, cfg, device="cpu")
    batch = _smoke_batch(cfg)
    jtc, tcfg = jts.TrainConfig(remat=True), TrainConfig(remat=True)
    want, _ = jax.jit(lambda p, b: jts.loss_fn(p, jcfg, b, jtc))(params, batch)
    with torch.no_grad():
        got, _ = loss_fn(model, cfg, batch, tcfg)
    assert float(got) == pytest.approx(float(want), rel=TOL)
    grads, _ = grads_fn(model, cfg, batch, tcfg)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    tcfg = dataclasses.replace(tcfg, optimizer=topt.AdamWConfig(warmup_steps=1))
    train_step(model, topt.adamw_init(model), None, batch, cfg=cfg, tcfg=tcfg)
    with torch.no_grad():
        moved, _ = loss_fn(model, cfg, batch, tcfg)
    assert math.isfinite(float(moved))
    assert float(moved) != pytest.approx(float(got), rel=1e-9)


def test_remat_forward_keeps_the_logits_and_the_tail():
    """remat=True on a depth with a tail layer outside the blocks
    (recurrentgemma's period of 3 at 4 layers): the logits and the MoE
    aux of remat=False, and gradients within 1e-5."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(), num_layers=4)
    gen = torch.Generator().manual_seed(3)
    model = init_model(cfg, generator=gen, device="cpu")
    batch = _smoke_batch(cfg, seed=3)
    with torch.no_grad():
        a = forward(model, cfg, batch["tokens"], remat=True).logits
        b = forward(model, cfg, batch["tokens"]).logits
    assert torch.equal(a, b)
    ga, _ = grads_fn(model, cfg, batch, TrainConfig(remat=True))
    gb, _ = grads_fn(model, cfg, batch, TrainConfig(remat=False))
    assert _leaf_gap(ga, gb) <= TOL


# ---------------------------------------------------------------------------
# compression, tokens
# ---------------------------------------------------------------------------


def test_quantize_dequantize_psum_sim_matches_the_reference():
    """Two steps of error feedback on leaves of 256-multiple and ragged
    sizes, against the reference's."""
    rng = np.random.default_rng(11)
    shapes = [(16, 32), (7, 5), (300,)]
    jerr, terr = None, None
    for _ in range(2):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jg, jerr = jcomp.quantize_dequantize_psum_sim(
            [jnp.asarray(g) for g in grads], jerr
        )
        tg, terr = tcomp.quantize_dequantize_psum_sim(
            [torch.tensor(g) for g in grads], terr
        )
        for got, want in zip(tg + terr, jg + jerr):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    q, s = tcomp._quantize(torch.tensor([0.5, 1.5, 2.5, -127.0]), block=4)
    assert q.tolist() == [[0, 2, 2, -127]]  # 127 * x / 127: half to even


def test_synthetic_tokens_equal_the_reference():
    j = jtok.SyntheticTokens(1000, 16, 4, seed=3)
    t = ttok.SyntheticTokens(1000, 16, 4, seed=3)
    for step in (0, 1, 17):
        jb, tb = j.batch(step), t.batch(step)
        for key in ("tokens", "targets"):
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


def test_memmap_corpus_and_prefetcher(tmp_path):
    path = str(tmp_path / "corpus.bin")
    ttok.MemmapCorpus.write_synthetic(path, 10_000, vocab=50, seed=0)
    ds = ttok.MemmapCorpus(path, seq_len=16, global_batch=4)
    b0a = ds.batch(0)
    b0b = ds.batch(0)
    np.testing.assert_array_equal(b0a["tokens"], b0b["tokens"])  # resumable
    assert b0a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b0a["tokens"][:, 1:], b0a["targets"][:, :-1])
    ref = jtok.MemmapCorpus(path, seq_len=16, global_batch=4)
    np.testing.assert_array_equal(ds.batch(5)["tokens"], ref.batch(5)["tokens"])

    pf = ttok.Prefetcher(ds, start_step=3, depth=2)
    it = iter(pf)
    s, b = next(it)
    assert s == 3
    np.testing.assert_array_equal(b["tokens"], ds.batch(3)["tokens"])
    pf.stop()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN = TrainConfig(remat=False, optimizer=FAST)


def _replay(model, cfg, data, steps, tcfg=TRAIN):
    """The state after ``train_step`` over the data of ``steps``, in order."""
    opt = topt.adamw_init(model)
    for i in steps:
        batch = data.batch(i)
        model, opt, _, _ = train_step(model, opt, None, batch, cfg=cfg, tcfg=tcfg)
    return model, opt


def _equal_state(a: Trainer, model, opt) -> bool:
    pairs = zip(
        list(a.params.parameters()) + a.opt_state.master + a.opt_state.m,
        list(model.parameters()) + opt.master + opt.m,
    )
    return all(torch.equal(x, y) for x, y in pairs)


def _seeded(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return init_model(cfg, generator=gen, device="cpu")


class Boom(RuntimeError):
    pass


def _crash_at_8(step, batch):
    if step == 8:
        raise Boom()


def _crash_resume(tmp_path, cfg):
    """tests/test_training_substrate.py's crash at step 8 and resume by a
    fresh Trainer, beside an uninterrupted run: (resumed, uninterrupted),
    both logging every step."""
    data = ttok.SyntheticTokens(cfg.vocab_size, 16, 4, seed=4)
    step_fn = make_train_step(cfg, None, TRAIN)

    def config(d):
        return TrainerConfig(
            total_steps=12, checkpoint_every=5, log_every=1, checkpoint_dir=str(d)
        )

    a = tmp_path / "a"
    t1 = Trainer(step_fn, _seeded(cfg, 0), data, config(a), fault_hook=_crash_at_8)
    with pytest.raises(Boom):
        t1.run()
    t1.ckpt.wait()
    assert latest_step(str(a)) == 5  # survived the crash

    t2 = Trainer(step_fn, _seeded(cfg, 99), data, config(a))  # fresh process
    out = t2.run()
    assert out["final_step"] == 12
    assert latest_step(str(a)) == 12
    t3 = Trainer(step_fn, _seeded(cfg, 0), data, config(tmp_path / "b"))
    t3.run()
    losses = [m["loss"] for m in t2.metrics_log]
    assert losses == [m["loss"] for m in t3.metrics_log[5:]]
    return t2, t3


def test_trainer_resume_after_crash(tmp_path):
    """A fresh Trainer (other weights) resumes from LATEST and ends in the
    uninterrupted run's state, bit for bit."""
    t2, t3 = _crash_resume(tmp_path, get_arch(ARCH).reduced())
    assert _equal_state(t2, t3.params, t3.opt_state)


def test_bf16_trainer_resumes_from_the_master_copy(tmp_path):
    """A bf16 model checkpoints no bf16 leaf: the restore rebuilds the
    parameters from the f32 master, which they equal bit for bit after
    every step; crashed and resumed, it gives the uninterrupted losses."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="bfloat16")
    t2, t3 = _crash_resume(tmp_path, cfg)
    assert all(p.dtype == torch.bfloat16 for p in t2.params.parameters())
    assert _equal_state(t2, t3.params, t3.opt_state)
    for p, master in zip(t2.params.parameters(), t2.opt_state.master):
        assert torch.equal(p, master.to(torch.bfloat16))


@functools.cache
def _reference_step():
    jcfg, _, _, _ = _setup()
    jtc = jts.TrainConfig(remat=False)

    def step(params, opt_state, errors, batch):
        batch = _jbatch(batch)
        return jts.train_step(params, opt_state, errors, batch, cfg=jcfg, tcfg=jtc)

    return jax.jit(step)


def _poison_at(nan_step):
    """A fault hook that makes the loss of ``nan_step`` NaN by handing the
    model NaN input embeddings for that step's batch."""

    def hook(step, batch):
        if step == nan_step:
            b, s = batch["tokens"].shape
            batch["embeds"] = np.full((b, s, 128), np.nan, np.float32)

    return hook


@pytest.mark.parametrize(
    "nan_step, every, kept",
    [
        (5, 2, [0, 1, 2, 3, 6, 7]),  # tests/test_training_substrate.py's case
        (1, 4, [0, 2, 3, 4, 5, 6, 7]),  # before the first checkpoint
    ],
)
def test_trainer_nan_recovery_ends_in_the_reference_state(
    tmp_path, nan_step, every, kept
):
    """A NaN loss restores the last checkpoint, or keeps the state from
    before the step where none exists yet, and skips the step's data: the
    port ends in the state of ``train_step`` over the ``kept`` steps (bit
    for bit), and in the reference trainer's (1e-5)."""
    _, params, cfg, _ = _setup()
    data = ttok.SyntheticTokens(cfg.vocab_size, 16, 4, seed=5)
    hook = _poison_at(nan_step)

    def config(cls, d):
        return cls(
            total_steps=8, checkpoint_every=every, log_every=1, checkpoint_dir=str(d)
        )

    tcfg = TrainConfig(remat=False)
    step_fn = make_train_step(cfg, None, tcfg)
    tconfig = config(TrainerConfig, tmp_path / "t")
    t = Trainer(step_fn, _model(), data, tconfig, fault_hook=hook)
    out = t.run()
    assert out["final_step"] == 8
    assert out["nan_restores"] == 1  # recovered exactly once
    assert latest_step(str(tmp_path / "t")) == 8  # run completed + checkpointed
    model, opt = _replay(_model(), cfg, data, kept, tcfg)
    assert _equal_state(t, model, opt)

    jconfig = config(JTrainerConfig, tmp_path / "j")
    jt = JTrainer(_reference_step(), params, data, jconfig, fault_hook=hook)
    jout = jt.run()
    assert jout["nan_restores"] == 1
    assert [m["step"] for m in jout["log"]] == [m["step"] for m in out["log"]]
    want = adamw_state_from_numpy(_np(jt.opt_state), cfg, device="cpu")
    assert int(t.opt_state.step) == int(want.step) == len(kept)
    assert _param_gap(t.params, want.master) <= TOL
    assert _leaf_gap(t.opt_state.v, want.v) <= TOL

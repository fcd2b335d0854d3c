"""The port's LM serving path against the reference on the CPU.

Reduced configs (2 layers, d 128, B = 2, S = 64, as tests/test_models_smoke.py)
of the dense, attention-only architectures (the MoE, recurrent and frontend
ones are in tests/test_torch_moe.py and tests/test_torch_recurrent.py): the
reference's ``init_model`` weights carried across
(``convert.lm_params_from_numpy``), then ``forward`` for each attention
implementation, greedy ``generate`` token for token, the port's own
decode-matches-forward, and the windowed ring cache: bounded, refusing a
prefill longer than the window, and the reference's fault there.  Each of
the ten LM configs equals the reference's field for field.
"""

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

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import LM_ARCH_NAMES  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.mlp import init_mlp as j_init_mlp  # noqa: E402
from repro.models.mlp import mlp as j_mlp  # noqa: E402
from repro.serving.engine import generate as j_generate  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    forward,
    init_caches,
    init_model,
    param_count,
)
from repro_torch.models.mlp import MLP  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402

B, S = 2, 64
CONFIGS = {
    "qwen3-mqa": ("qwen3-4b", {}),  # reduced: kv = 1
    "qwen3-gqa": ("qwen3-4b", {"num_kv_heads": 2}),
    "phi3-mha": ("phi3-mini-3.8b", {}),  # no qk-norm
    "granite": ("granite-34b", {}),
    "qwen3-swa16": ("qwen3-4b", {"layer_pattern": ("swa",), "window": 16}),
}
IMPLS = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}


@functools.cache
def _setup(name):
    """(reference cfg, reference params, port cfg, port model, tokens)."""
    arch, kw = CONFIGS[name]
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S))
    return jcfg, params, cfg, model, tokens


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name, impl):
    jcfg, params, cfg, model, tokens = _setup(name)
    want = jax.jit(
        lambda p, t: j_forward(p, jcfg, tokens=t, attn_impl=IMPLS[impl]).logits
    )(params, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        out = forward(model, cfg, torch.as_tensor(tokens), attn_impl=impl)
    assert out.logits.shape == (B, S, cfg.vocab_size)
    assert float(out.aux_loss) == 0.0 and out.caches is None
    got = out.logits.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_kernel_impl_goes_through_the_kernel_dispatch(monkeypatch):
    """On the CPU ``attn_impl="kernel"`` reaches ``ops.attention`` once a
    layer (which takes the plain version here and the kernel on the card)."""
    _, _, cfg, model, tokens = _setup("qwen3-gqa")
    calls = []
    attention = ops.attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    with torch.inference_mode():
        forward(model, cfg, torch.as_tensor(tokens), attn_impl="kernel")
        forward(model, cfg, torch.as_tensor(tokens), attn_impl="naive")
    hd = cfg.resolved_head_dim
    want = ((B * cfg.num_heads, S, hd), (B * cfg.num_kv_heads, S, hd))
    assert [c[:2] for c in calls] == [want] * cfg.num_layers
    assert all(c[2] == dict(causal=True, window=0) for c in calls)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_matches_reference_token_for_token(name):
    """Greedy tokens of prompt + 8 steps: a prompt of 32, or of the window
    where the cache is windowed (a longer prefill is refused, see below)."""
    jcfg, params, cfg, model, tokens = _setup(name)
    prompt = tokens[:, : min(32, cfg.window or 32)]
    want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompt, jnp.int32), 8))
    got = generate(model, cfg, torch.as_tensor(prompt), 8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_forward(name):
    """Prefill S - 1 tokens (the window's worth where the cache is windowed),
    then decode one token at a time to S - 1: each step's logits equal the
    cacheless forward's at that position (the reference's tolerance)."""
    _, _, cfg, model, tokens = _setup(name)
    t = torch.as_tensor(tokens)
    pre = min(S - 1, cfg.window or S)
    with torch.inference_mode():
        full = forward(model, cfg, t).logits
        caches = init_caches(cfg, B, S, device="cpu")
        positions = torch.arange(pre, dtype=torch.int32)[None]
        out = forward(model, cfg, t[:, :pre], positions=positions, caches=caches)
        caches = out.caches
        for pos in range(pre, S):
            logits, caches = decode_step(
                model, cfg, caches, tokens=t[:, pos], pos=pos
            )
            np.testing.assert_allclose(
                logits.numpy(), full[:, pos].numpy(), rtol=2e-3, atol=2e-3
            )


def test_windowed_cache_is_bounded():
    _, _, cfg, _, _ = _setup("qwen3-swa16")
    caches = init_caches(cfg, batch=1, max_len=100_000, device="cpu")
    assert all(c["k"].shape[1] == cfg.window for c in caches)
    assert all(c["kpos"].shape == (cfg.window,) for c in caches)


def test_windowed_prefill_longer_than_the_window_is_refused():
    _, _, cfg, model, tokens = _setup("qwen3-swa16")
    caches = init_caches(cfg, B, S, device="cpu")
    with pytest.raises(ValueError, match="Queue 3"):
        too_long = torch.as_tensor(tokens[:, : cfg.window + 1])
        forward(model, cfg, too_long, caches=caches)
    with pytest.raises(ValueError, match="Queue 3"):
        generate(model, cfg, torch.as_tensor(tokens[:, :32]), 2)


def test_reference_windowed_prefill_fault_is_recorded():
    """The reference's fault the guard above refuses (ROADMAP Queue 3): a
    cached prefill of 63 tokens into 16-slot ring caches overwrites keys that
    earlier queries of the prefill need, so its logits, and the decode step
    after it, differ from the cacheless forward's."""
    cfg = dataclasses.replace(
        j_get_arch("qwen3-4b").reduced(), layer_pattern=("swa",), window=16
    )
    params = j_init_model(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(
        jax.random.PRNGKey(2), (2, 64), 0, cfg.vocab_size, jnp.int32
    )

    @jax.jit
    def run(params, tokens):
        full = j_forward(params, cfg, tokens=tokens).logits
        pre = j_forward(
            params,
            cfg,
            tokens=tokens[:, :63],
            positions=jnp.arange(63, dtype=jnp.int32)[None],
            caches=j_init_caches(cfg, 2, 64),
        )
        step, _ = j_decode_step(params, cfg, pre.caches, tokens=tokens[:, 63], pos=63)
        return full, pre.logits, step

    full, pre, step = (np.asarray(x) for x in run(params, tokens))
    assert np.abs(pre - full[:, :63]).max() > 0.1
    assert np.abs(step - full[:, 63]).max() > 0.1


def test_unported_configs_and_options_raise():
    """All ten LM architectures resolve and an unknown arch is a KeyError;
    training's ``remat=True`` gives the logits of ``remat=False``, and a
    cached call refuses it."""
    for name in LM_ARCH_NAMES:
        assert get_arch(name).name == name
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("geostat-tlr")
    _, _, cfg, model, tokens = _setup("qwen3-mqa")
    with torch.inference_mode():
        remat = forward(model, cfg, torch.as_tensor(tokens), remat=True).logits
        plain = forward(model, cfg, torch.as_tensor(tokens)).logits
    assert torch.equal(remat, plain)
    with pytest.raises(ValueError, match="cached call"):
        forward(
            model,
            cfg,
            torch.as_tensor(tokens),
            remat=True,
            caches=init_caches(cfg, B, S, device="cpu"),
        )


@pytest.mark.parametrize("name", LM_ARCH_NAMES)
def test_param_count_is_the_reference_init_models(name):
    """``param_count`` (chip_smoke.py's parameter gate) from the config's
    shapes: the reference's ``init_model`` count at full size and at a cut
    depth, and the port's own model's at the reduced size."""
    for depth in (None, 3):
        jcfg, cfg = j_get_arch(name), get_arch(name)
        if depth:
            jcfg = dataclasses.replace(jcfg, num_layers=depth)
            cfg = dataclasses.replace(cfg, num_layers=depth)
        shapes = jax.eval_shape(lambda k: j_init_model(k, jcfg), jax.random.PRNGKey(0))
        assert param_count(cfg) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)
        )
    small = get_arch(name).reduced()
    model = init_model(small, device="cpu")
    assert param_count(small) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", LM_ARCH_NAMES)
def test_config_equals_the_reference_field_for_field(name):
    got, want = get_arch(name), j_get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())


def test_init_model_draws_the_reference_shapes_from_a_generator():
    cfg = get_arch("qwen3-4b").reduced()
    a = init_model(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = init_model(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    jcfg = j_get_arch("qwen3-4b").reduced()
    shapes = jax.eval_shape(lambda k: j_init_model(k, jcfg), jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].attn.wq.weight
    assert w.abs().max() <= 2.0 * cfg.d_model**-0.5


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    """Both feed-forward kinds (GELU is the tanh form, jax.nn.gelu's default)."""
    params = j_init_mlp(jax.random.PRNGKey(3), 128, 256, kind, jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 8, 128)).astype(np.float32)
    want = jax.jit(lambda p, x: j_mlp(p, x, kind))(params, jnp.asarray(x))
    gen = torch.Generator()
    layer = MLP(128, 256, kind, torch.float32, generator=gen, device="cpu")
    with torch.no_grad():
        for name in ("w_gate", "w_up", "w_down"):
            if getattr(params, name) is not None:
                w = np.array(getattr(params, name)).T
                getattr(layer, name).weight.copy_(torch.as_tensor(w))
        got = layer(torch.as_tensor(x))
    assert (layer.w_gate is None) == (kind == "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

"""The port's mixture-of-experts serving path against the reference on the CPU.

``moe_block`` (outputs and aux loss, with capacity drops forced and
dropless) for both MoE families (mixtral: 8 experts top-2; llama4: top-1
with a shared expert), then the whole reduced mixtral and llama4 (2
pattern periods, d 128, B = 2, S = 64, the reference's ``init_model``
weights carried across by ``convert.lm_params_from_numpy``): ``forward``
and its aux loss for each attention implementation, greedy ``generate``
token for token and decode-matches-forward.
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
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.moe import moe_block as j_moe_block  # noqa: E402
from repro.serving.engine import generate as j_generate  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import copy_weights, lm_params_from_numpy  # noqa: E402
from repro_torch.models import decode_step, forward, init_caches  # noqa: E402
from repro_torch.models.moe import MoE, _capacity, moe_block  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402

B, S = 2, 64
ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
IMPLS = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}
# a capacity factor that makes each expert drop pairs at T = B S tokens
DROP_FACTOR = 0.5


@functools.cache
def _setup(name):
    """(reference cfg, reference params, port cfg, port model, tokens)."""
    jcfg = j_get_arch(name).reduced()
    cfg = get_arch(name).reduced()
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S))
    return jcfg, params, cfg, model, tokens


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_matches_reference(name, dropless):
    """Outputs and aux loss; without ``dropless`` at a capacity factor
    that drops pairs (asserted from the router's top-k counts)."""
    kw = {} if dropless else {"capacity_factor": DROP_FACTOR}
    jcfg = dataclasses.replace(j_get_arch(name).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(name).reduced(), **kw)
    params = j_init_moe(jax.random.PRNGKey(7), jcfg, jnp.float32)
    layer = MoE(cfg, torch.float32, generator=torch.Generator(), device="cpu")
    copy_weights(layer, jax.tree.map(np.asarray, params))
    assert (layer.shared is None) == (not cfg.moe_shared_expert)
    x = np.random.default_rng(8).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda p, x: j_moe_block(p, x, jcfg, dropless=dropless))(
        params, jnp.asarray(x)
    )
    with torch.inference_mode():
        got, aux = moe_block(layer, torch.as_tensor(x), cfg, dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if not dropless:
        logits = x.reshape(-1, cfg.d_model) @ np.asarray(params.router)
        top = np.argsort(-logits, axis=-1)[:, : cfg.experts_per_token]
        cap = _capacity(B * S, cfg.experts_per_token, cfg.num_experts, DROP_FACTOR)
        assert np.bincount(top.ravel(), minlength=cfg.num_experts).max() > cap


def test_moe_expert_weights_keep_the_reference_layout():
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    layer = MoE(cfg, torch.float32, generator=torch.Generator(), device="cpu")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    assert layer.router.dtype == torch.float32 and layer.router.shape == (d, e)
    assert layer.w_gate.shape == layer.w_up.shape == (e, d, f)
    assert layer.w_down.shape == (e, f, d)
    bf16 = MoE(cfg, torch.bfloat16, generator=torch.Generator(), device="cpu")
    assert bf16.router.dtype == torch.float32 and bf16.w_up.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_aux_loss_match_reference(name, impl):
    jcfg, params, cfg, model, tokens = _setup(name)
    want = jax.jit(lambda p, t: j_forward(p, jcfg, tokens=t, attn_impl=IMPLS[impl]))(
        params, jnp.asarray(tokens, jnp.int32)
    )
    with torch.inference_mode():
        out = forward(model, cfg, torch.as_tensor(tokens), attn_impl=impl)
    np.testing.assert_allclose(
        out.logits.numpy(), np.asarray(want.logits), rtol=1e-4, atol=1e-4
    )
    assert float(out.aux_loss) > 0
    np.testing.assert_allclose(float(out.aux_loss), float(want.aux_loss), rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference_token_for_token(name):
    jcfg, params, cfg, model, tokens = _setup(name)
    prompt = tokens[:, :32]
    want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompt, jnp.int32), 8))
    got = generate(model, cfg, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_dropless_forward(name):
    """Prefill S - 1 tokens, then decode the last: each step's logits equal
    the cacheless dropless forward's (the reference's tolerance)."""
    _, _, cfg, model, tokens = _setup(name)
    t = torch.as_tensor(tokens)
    pre = min(S - 1, cfg.window or S)
    with torch.inference_mode():
        full = forward(model, cfg, t, dropless=True).logits
        caches = init_caches(cfg, B, S, device="cpu")
        positions = torch.arange(pre, dtype=torch.int32)[None]
        out = forward(model, cfg, t[:, :pre], positions=positions, caches=caches)
        np.testing.assert_allclose(
            out.logits.numpy(), full[:, :pre].numpy(), rtol=2e-3, atol=2e-3
        )
        caches = out.caches
        for pos in range(pre, S):
            logits, caches = decode_step(model, cfg, caches, tokens=t[:, pos], pos=pos)
            np.testing.assert_allclose(
                logits.numpy(), full[:, pos].numpy(), rtol=2e-3, atol=2e-3
            )

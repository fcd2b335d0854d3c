"""The port's recurrent and frontend serving paths against the reference on
the CPU.

The SSD core (``ssd_chunked``), the Mamba-2 mixer (``ssm_block``: a prefill
whose length is not a multiple of the chunk, and a decode step) and the
RG-LRU block (prefill and decode), then the whole reduced mamba2,
recurrentgemma, pixtral and musicgen (2 pattern periods, d 128, B = 2,
S = 64, the reference's ``init_model`` weights carried across):
``forward`` for each attention implementation (pixtral and musicgen
through ``embeds=``), greedy ``generate`` token for token and
decode-matches-forward; the frontend stubs; and the reference's recurrent
prefill fault, which the port refuses (ROADMAP Queue 3).
"""

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
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.serving.engine import generate as j_generate  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import copy_weights, lm_params_from_numpy  # noqa: E402
from repro_torch.models import decode_step, forward, init_caches  # noqa: E402
from repro_torch.models import frontends, rglru, ssm  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402

B, S = 2, 64
RECURRENT = ("mamba2-780m", "recurrentgemma-9b")
FRONTENDS = ("pixtral-12b", "musicgen-medium")
IMPLS = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _setup(name):
    """(reference cfg, reference params, port cfg, port model, tokens,
    embeddings)."""
    jcfg = j_get_arch(name).reduced()
    cfg = get_arch(name).reduced()
    params = j_init_model(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(_np(params), cfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S))
    embeds = (0.02 * rng.normal(size=(B, S, cfg.d_model))).astype(np.float32)
    return jcfg, params, cfg, model, tokens, embeds


def _module(kind, name, seed):
    """(reference cfg, reference params, port cfg, port block) of one
    layer's mixer, the port's weights copied from the reference's."""
    jcfg = j_get_arch(name).reduced()
    cfg = get_arch(name).reduced()
    if kind == "ssm":
        params = j_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
        block = ssm.SSM(cfg, torch.float32, generator=torch.Generator(), device="cpu")
    else:
        params = j_rglru.init_rglru(jax.random.PRNGKey(seed), jcfg, jnp.float32)
        block = rglru.RGLRU(
            cfg, torch.float32, generator=torch.Generator(), device="cpu"
        )
    copy_weights(block, _np(params))
    return jcfg, params, cfg, block


def test_ssd_chunked_matches_reference():
    rng = np.random.default_rng(2)
    b, s, h, p, g, n, chunk = 2, 64, 4, 8, 2, 16, 16
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 1e-1, size=(b, s, h)).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bm, cm = (rng.normal(size=(b, s, g, n)).astype(np.float32) for _ in range(2))
    want_y, want_state = jax.jit(j_ssm.ssd_chunked, static_argnums=5)(
        xh, dt, a_log, bm, cm, chunk
    )
    got_y, got_state = ssm.ssd_chunked(
        *(torch.as_tensor(a) for a in (xh, dt, a_log, bm, cm)), chunk
    )
    assert got_state.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got_state.numpy(), np.asarray(want_state), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("mode", ["prefill_ragged", "decode"])
def test_ssm_block_matches_reference(mode):
    """A prefill of 50 tokens (not a multiple of the chunk of 16: padded
    with dt = 0 steps) from no state, and a decode step from a random
    state."""
    jcfg, params, cfg, block = _module("ssm", "mamba2-780m", 3)
    rng = np.random.default_rng(4)
    s = 50 if mode == "prefill_ragged" else 1
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    state = None
    if mode == "decode":
        zero = j_ssm.init_ssm_state(jcfg, B, jnp.float32)
        state = {
            key: rng.normal(size=v.shape).astype(np.float32) for key, v in zero.items()
        }
    want, want_state = jax.jit(lambda p, x, st: j_ssm.ssm_block(p, x, jcfg, st))(
        params, x, state
    )
    tstate = state and {k: torch.as_tensor(v) for k, v in state.items()}
    with torch.inference_mode():
        got, got_state = ssm.ssm_block(block, torch.as_tensor(x), cfg, tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert got_state["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(
            got_state[key].numpy(), np.asarray(want_state[key]), rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_rglru_block_matches_reference(mode):
    jcfg, params, cfg, block = _module("rglru", "recurrentgemma-9b", 5)
    assert block.w_a.shape == (cfg.lru_width, cfg.lru_width)
    rng = np.random.default_rng(6)
    s = S if mode == "prefill" else 1
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    state = None
    if mode == "decode":
        zero = j_rglru.init_rglru_state(jcfg, B, jnp.float32)
        state = {
            key: rng.normal(size=v.shape).astype(np.float32) for key, v in zero.items()
        }
    want, want_state = jax.jit(lambda p, x, st: j_rglru.rglru_block(p, x, jcfg, st))(
        params, x, state
    )
    tstate = state and {k: torch.as_tensor(v) for k, v in state.items()}
    with torch.inference_mode():
        got, got_state = rglru.rglru_block(block, torch.as_tensor(x), cfg, tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert got_state["h"].dtype == torch.float32
    for key in ("conv", "h"):
        np.testing.assert_allclose(
            got_state[key].numpy(), np.asarray(want_state[key]), rtol=1e-4, atol=1e-5
        )


def test_rglru_scan_matches_a_loop():
    rng = np.random.default_rng(7)
    log_a = torch.as_tensor(-rng.uniform(0, 0.2, size=(2, 37, 5)))
    b = torch.as_tensor(rng.normal(size=(2, 37, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        want.append(h)
    got = rglru.rglru_scan(log_a, b)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(), rtol=1e-12)


def _inputs(name):
    """The forward's keyword for the reference and the port: tokens, or
    the frontend archs' embeddings."""
    _, _, _, _, tokens, embeds = _setup(name)
    if name in FRONTENDS:
        return dict(embeds=jnp.asarray(embeds)), dict(embeds=torch.as_tensor(embeds))
    return (
        dict(tokens=jnp.asarray(tokens, jnp.int32)),
        dict(tokens=torch.as_tensor(tokens)),
    )


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", RECURRENT + FRONTENDS)
def test_forward_matches_reference(name, impl):
    jcfg, params, cfg, model, _, _ = _setup(name)
    jkw, tkw = _inputs(name)
    want = jax.jit(lambda p, kw: j_forward(p, jcfg, attn_impl=IMPLS[impl], **kw))(
        params, jkw
    )
    with torch.inference_mode():
        out = forward(model, cfg, attn_impl=impl, **tkw)
    assert out.logits.shape == (B, S, cfg.vocab_size) and float(out.aux_loss) == 0.0
    np.testing.assert_allclose(
        out.logits.numpy(), np.asarray(want.logits), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("name", RECURRENT + FRONTENDS)
def test_generate_matches_reference_token_for_token(name):
    jcfg, params, cfg, model, tokens, _ = _setup(name)
    prompt = tokens[:, :32]
    want = np.asarray(j_generate(params, jcfg, jnp.asarray(prompt, jnp.int32), 8))
    got = generate(model, cfg, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", RECURRENT + FRONTENDS)
def test_decode_matches_forward(name):
    """Prefill 48 tokens from position 0, then decode one token a call to
    S - 1 (through ``embeds=`` for the frontend archs): each step's logits
    equal the cacheless forward's (the reference's tolerance)."""
    _, _, cfg, model, tokens, embeds = _setup(name)
    pre = 48
    if name in FRONTENDS:
        seq = torch.as_tensor(embeds)
        kw = lambda sl: dict(embeds=seq[:, sl])  # noqa: E731
    else:
        seq = torch.as_tensor(tokens)
        kw = lambda sl: dict(tokens=seq[:, sl])  # noqa: E731
    with torch.inference_mode():
        full = forward(model, cfg, **kw(slice(None))).logits
        caches = init_caches(cfg, B, S, device="cpu")
        positions = torch.arange(pre, dtype=torch.int32)[None]
        out = forward(
            model, cfg, positions=positions, caches=caches, **kw(slice(0, pre))
        )
        np.testing.assert_allclose(
            out.logits.numpy(), full[:, :pre].numpy(), rtol=2e-3, atol=2e-3
        )
        caches = out.caches
        for pos in range(pre, S):
            logits, caches = decode_step(model, cfg, caches, pos=pos, **kw(pos))
            np.testing.assert_allclose(
                logits.numpy(), full[:, pos].numpy(), rtol=2e-3, atol=2e-3
            )


def test_init_caches_give_each_layer_its_kind_of_cache():
    cfg = get_arch("recurrentgemma-9b").reduced()
    caches = init_caches(cfg, B, 1000, device="cpu")
    for i, cache in enumerate(caches):
        kind = cfg.layer_kind(i)
        if kind == "rglru":
            assert cache["conv"].shape == (B, 3, cfg.lru_width)
            assert cache["h"].dtype == torch.float32
        else:
            assert kind == "local" and cache["k"].shape[1] == cfg.window
    m = get_arch("mamba2-780m").reduced()
    (first, *_) = init_caches(m, B, 1000, device="cpu")
    assert first["ssm"].shape == (B, 2 * m.d_model // m.ssm_head_dim, m.ssm_state, 16)
    assert first["ssm"].dtype == torch.float32


@pytest.mark.parametrize("frontend", ["audio_stub", "vision_stub"])
def test_frontend_embeddings_draw_from_the_generator(frontend):
    a = frontends.frontend_embeddings(
        frontend, torch.Generator().manual_seed(3), 2, 8, 16, torch.bfloat16
    )
    b = frontends.frontend_embeddings(
        frontend, torch.Generator().manual_seed(3), 2, 8, 16, torch.bfloat16
    )
    assert a.shape == (2, 8, 16) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and 0.005 < float(a.float().std()) < 0.05
    with pytest.raises(ValueError):
        frontends.frontend_embeddings("none", torch.Generator(), 1, 1, 1, torch.float32)


@pytest.mark.parametrize("name", RECURRENT)
def test_reference_recurrent_prefill_fault_is_recorded(name):
    """The reference's fault the port refuses (ROADMAP Queue 3): a cached
    prefill of 32 tokens, then a second cached call for tokens 32-63,
    restarts the SSD / RG-LRU recurrence from zero (only the conv state is
    carried), so the second call's logits differ from the cacheless
    forward's (by 0.066 for mamba2 and 1.13 for recurrentgemma on these
    tokens, logits of scale 0.95); the first call's match."""
    jcfg, params, _, _, tokens, _ = _setup(name)
    tok = jnp.asarray(tokens, jnp.int32)

    @jax.jit
    def run(params, tok):
        full = j_forward(params, jcfg, tokens=tok).logits
        first = j_forward(
            params,
            jcfg,
            tokens=tok[:, :32],
            positions=jnp.arange(32, dtype=jnp.int32)[None],
            caches=j_init_caches(jcfg, B, S),
        )
        second = j_forward(
            params,
            jcfg,
            tokens=tok[:, 32:],
            positions=jnp.arange(32, 64, dtype=jnp.int32)[None],
            caches=first.caches,
        )
        return full, first.logits, second.logits

    full, first, second = (np.asarray(x) for x in run(params, tok))
    assert np.abs(first - full[:, :32]).max() < 1e-4
    assert np.abs(second - full[:, 32:]).max() > 0.05


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_prefill_after_tokens_is_refused(name):
    """A cached call of several tokens after position 0 raises; decoding one
    token a call after a prefill from 0 is the supported path (above)."""
    _, _, cfg, model, tokens, _ = _setup(name)
    t = torch.as_tensor(tokens)
    with torch.inference_mode():
        caches = init_caches(cfg, B, S, device="cpu")
        positions = torch.arange(32, dtype=torch.int32)[None]
        out = forward(model, cfg, t[:, :32], positions=positions, caches=caches)
        with pytest.raises(ValueError, match="Queue 3"):
            forward(model, cfg, t[:, 32:], positions=positions + 32, caches=out.caches)
        _, caches = decode_step(model, cfg, out.caches, tokens=t[:, 32], pos=32)

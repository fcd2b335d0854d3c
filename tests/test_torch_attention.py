"""The port's attention against the reference on the CPU.

The plain version of the flash kernel (``repro_torch.kernels.ref.attention_ref``)
against the Pallas kernel in interpret mode and the reference's
``attention_ref``, at the shapes of tests/test_kernels.py; the attention
layer (``multihead_attention``, qk-norm and RoPE) for each inner
implementation; the ring-buffer cache through prefill and decode; a plain
emulation of the bf16 kernel instance's arithmetic (P rounded to bf16) against
the Pallas kernel.  The CUDA kernel itself is held against ``attention_ref``
on the card by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    instance,
)
from repro_torch.models import attention as t_attn  # noqa: E402

# as tests/test_kernels.py: bf16 at 2e-2, f32 at the window and decode tests'
TOL = {
    "float32": dict(rtol=2e-5, atol=2e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
}
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _qkv(seed, bh, bkv, sq, skv, d, dname):
    """q, k, v made with numpy, rounded to the dtype once: (jax, torch)."""
    jdt, tdt = DTYPES[dname]
    rng = np.random.default_rng(seed)
    shapes = ((bh, sq, d), (bkv, skv, d), (bkv, skv, d))
    js = [jnp.asarray(rng.normal(size=s), jdt) for s in shapes]
    ts = [torch.as_tensor(np.array(x, np.float32)).to(tdt) for x in js]
    return js, ts


def _check(got, js, dname, **kw):
    block_q = min(64, js[0].shape[1])
    want_flash = j_flash(*js, block_q=block_q, block_k=64, interpret=True, **kw)
    want_ref = j_ref.attention_ref(*js, **kw)
    got = got.float().numpy()
    for want in (want_flash, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dname])


@pytest.mark.parametrize(
    "bh,bkv,sq,skv,d",
    [
        (2, 2, 128, 128, 64),  # MHA square
        (4, 2, 128, 128, 64),  # GQA group=2
        (8, 2, 64, 256, 32),  # GQA group=4, Skv > Sq
    ],
)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_attention_ref_matches_flash_kernel_causal(bh, bkv, sq, skv, d, dname):
    js, ts = _qkv(5, bh, bkv, sq, skv, d, dname)
    got = ref.attention_ref(*ts, causal=True)
    assert got.dtype == ts[0].dtype and got.shape == (bh, sq, d)
    _check(got, js, dname, causal=True)


@pytest.mark.parametrize("window", [32, 64])
def test_attention_ref_matches_flash_kernel_sliding_window(window):
    js, ts = _qkv(6, 2, 2, 256, 256, 32, "float32")
    got = ref.attention_ref(*ts, causal=True, window=window)
    _check(got, js, "float32", causal=True, window=window)


def test_attention_ref_matches_flash_kernel_decode_single_query():
    js, ts = _qkv(7, 4, 2, 1, 512, 64, "float32")
    _check(ref.attention_ref(*ts, causal=True), js, "float32", causal=True)


def test_ops_attention_takes_the_plain_version_on_cpu_and_counts_nothing():
    _, ts = _qkv(8, 4, 2, 64, 64, 32, "float32")
    ops.reset_launch_counts()
    got = ops.attention(*ts, window=16)
    want = ref.attention_ref(*ts, window=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ops.launch_counts()["flash_attention"] == 0


def test_flash_wrapper_refuses_cpu_tensors_before_building():
    _, ts = _qkv(9, 2, 2, 64, 64, 32, "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(*ts)
    assert flash_attention_cuda.launches == 0


def test_flash_wrapper_picks_its_instance_by_dtype_and_refuses_others(monkeypatch):
    assert instance(torch.bfloat16) == "wgmma_bf16"
    assert instance(torch.float32) == "fma_f32"
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built the library"))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            instance(dtype)
        ts = [torch.zeros((2, 64, 32), dtype=dtype) for _ in range(3)]
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            flash_attention_cuda(*ts)
    assert flash_attention_cuda.launches == 0
    flash_attention_cuda.launches_by_instance["wgmma_bf16"] = 3
    ops.reset_launch_counts()
    assert flash_attention_cuda.launches_by_instance == {"wgmma_bf16": 0, "fma_f32": 0}


def _emulate_wgmma_bf16(q, k, v, *, causal=True, window=0):
    """The bf16 kernel instance's arithmetic in plain torch: 128-key tiles;
    S in f32 from the bf16 inputs, in log2 units (scale * log2 e); -1e30 for
    masked keys and as the running max's start; p = exp2(s - m); l summed
    from the f32 p; P rounded to bf16 before P V; the output
    acc / max(l, 1e-30) rounded to bf16.  Tiles the kernel skips are walked
    here: the source note of csrc/flash_attention.cu says why that gives the
    same result."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    scale_log2 = d**-0.5 * 1.4426950408889634
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, dim=0) for t in (k, v))
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((bh, sq, 1), -1e30)
    lsum = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, 128):
        kt, vt = kf[:, k0 : k0 + 128], vf[:, k0 : k0 + 128]
        s = (qf @ kt.mT) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        keep = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window > 0:
            keep &= kpos > qpos - window
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / lsum.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize(
    "bh,bkv,sq,skv,d,window",
    [
        (8, 2, 64, 256, 32, 0),  # causal GQA over two key tiles, Skv > Sq
        (2, 2, 256, 256, 32, 32),  # window 32
        (4, 2, 1, 512, 64, 0),  # a single decode query
    ],
)
def test_wgmma_bf16_arithmetic_matches_flash_kernel(bh, bkv, sq, skv, d, window):
    """P in bf16, the one rounding the bf16 instance adds, stays within the
    bf16 tolerance of the Pallas kernel and the reference."""
    js, ts = _qkv(10, bh, bkv, sq, skv, d, "bfloat16")
    got = _emulate_wgmma_bf16(*ts, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    kw = dict(window=window) if window else {}
    _check(got, js, "bfloat16", causal=True, **kw)


# ---------------------------------------------------------------------------
# The attention layer
# ---------------------------------------------------------------------------


def _layer(window=0, seed=0):
    """The reduced qwen3 config (qk-norm, RoPE theta 1e6, GQA 4/2 heads) and
    one attention layer's weights, random qk-norm scales included:
    (reference cfg, reference params, port cfg, port layer)."""
    kw = dict(num_kv_heads=2)
    if window:
        kw.update(layer_pattern=("swa",), window=window)
    jcfg = dataclasses.replace(j_get_arch("qwen3-4b").reduced(), **kw)
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), **kw)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    rng = np.random.default_rng(seed)
    shapes = dict(wq=(d, h * hd), wk=(d, kvh * hd), wv=(d, kvh * hd), wo=(h * hd, d))
    w = {n: rng.normal(size=s) / np.sqrt(s[0]) for n, s in shapes.items()}
    w["q_norm"], w["k_norm"] = (0.3 * rng.normal(size=hd) for _ in range(2))
    w = {n: a.astype(np.float32) for n, a in w.items()}
    jparams = j_attn.AttentionParams(**{n: jnp.asarray(a) for n, a in w.items()})
    gen = torch.Generator().manual_seed(0)
    layer = t_attn.Attention(cfg, torch.float32, generator=gen, device="cpu")
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(layer, n).weight.copy_(torch.as_tensor(w[n].T))
        layer.q_norm.copy_(torch.as_tensor(w["q_norm"]))
        layer.k_norm.copy_(torch.as_tensor(w["k_norm"]))
    return jcfg, jparams, cfg, layer


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("window", [0, 16])
def test_multihead_attention_matches_reference(impl, window):
    jcfg, jparams, cfg, layer = _layer(window)
    x = np.random.default_rng(1).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    jimpl = "pallas" if impl == "kernel" else impl
    want, _ = jax.jit(
        lambda p, x: j_attn.multihead_attention(
            p, x, jcfg, layer_window=window, impl=jimpl
        )
    )(jparams, jnp.asarray(x))
    with torch.inference_mode():
        got, cache = t_attn.multihead_attention(
            layer, torch.as_tensor(x), cfg, layer_window=window, impl=impl
        )
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_multihead_attention_refuses_an_unknown_impl():
    _, _, cfg, layer = _layer()
    with pytest.raises(ValueError, match="naive, chunked or kernel"):
        t_attn.multihead_attention(
            layer, torch.zeros((1, 4, cfg.d_model)), cfg, layer_window=0, impl="pallas"
        )


def test_ring_cache_prefill_and_decode_match_reference():
    """A 16-slot windowed cache: a prefill of 10 steps leaves slots 10-15
    empty (kpos = -1, masked); 14 decode steps then wrap the ring.  Output
    and cache agree with the reference's after every call."""
    window, pre, steps = 16, 10, 14
    jcfg, jparams, cfg, layer = _layer(window, seed=2)
    x = np.random.default_rng(3).normal(size=(2, pre + steps, cfg.d_model))
    x = x.astype(np.float32)
    jcache = j_attn.init_attention_cache(jcfg, 2, 64, window, jnp.float32)
    cache = t_attn.init_attention_cache(cfg, 2, 64, window, torch.float32, device="cpu")
    assert cache["k"].shape == (2, window, cfg.num_kv_heads, cfg.resolved_head_dim)

    @jax.jit
    def j_call(cache, x, positions):
        return j_attn.multihead_attention(
            jparams, x, jcfg, layer_window=window, positions=positions, cache=cache
        )

    spans = [(0, pre)] + [(p, p + 1) for p in range(pre, pre + steps)]
    for a, b in spans:
        positions = np.arange(a, b, dtype=np.int32)[None]
        want, jcache = j_call(jcache, jnp.asarray(x[:, a:b]), jnp.asarray(positions))
        with torch.inference_mode():
            got, cache = t_attn.multihead_attention(
                layer,
                torch.as_tensor(x[:, a:b]),
                cfg,
                layer_window=window,
                positions=torch.as_tensor(positions),
                cache=cache,
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(
                cache[key].numpy(), np.asarray(jcache[key]), rtol=1e-5, atol=1e-5
            )
        if b == pre:
            assert (cache["kpos"].numpy()[pre:] == -1).all()

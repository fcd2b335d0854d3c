"""The port's attention against the reference on the CPU.

The plain version of the flash kernel (``repro_torch.kernels.ref.attention_ref``)
against the Pallas kernel in interpret mode and the reference's
``attention_ref``, at the shapes of tests/test_kernels.py; the attention
layer (``multihead_attention``, qk-norm and RoPE) for each inner
implementation; the ring-buffer cache through prefill and decode; plain emulations of the
two kernel instances' arithmetic (bf16: P rounded to bf16; f32: the 3xTF32
split on tf32 parts) against the Pallas kernel.  The CUDA kernel itself is
held against ``attention_ref`` on the card by chip_smoke.py.
"""

import dataclasses
import re
from pathlib import Path

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
    assert instance(torch.float32) == "tf32x3_f32"
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
    assert flash_attention_cuda.launches_by_instance == {"wgmma_bf16": 0, "tf32x3_f32": 0}


def test_flash_wrapper_takes_head_dim_256_in_bf16_only(monkeypatch):
    """D = 256 (recurrentgemma's local attention) has a bf16 instance; the
    f32 instance refuses it before building (ROADMAP Queue 2), and both
    refuse a head dim they have no instance for."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built the library"))
    f32 = [torch.zeros((2, 64, 256)) for _ in range(3)]
    with pytest.raises(ValueError, match="tf32x3_f32.*D = 256.*Queue 2"):
        flash_attention_cuda(*f32)
    bf16 = [t.to(torch.bfloat16) for t in f32]
    with pytest.raises(ValueError, match="CUDA tensor"):  # past the head-dim check
        flash_attention_cuda(*bf16)
    for dtype in (torch.bfloat16, torch.float32):
        odd = [torch.zeros((2, 64, 80), dtype=dtype) for _ in range(3)]
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_cuda(*odd)
    assert flash_attention_cuda.launches == 0


CSRC = Path(_build.__file__).with_name("csrc") / "flash_attention.cu"


def _bf16_tile_keys(d):
    """Keys a tile of the bf16 instance at head dim d: ``Tile<D>::kBn`` in
    the .cu (128 up to D = 128, 64 at D = 256)."""
    text = CSRC.read_text().split("namespace hopper {", 1)[1]
    small, large = re.search(
        r"static constexpr int kBn = D <= 128 \? (\d+) : (\d+);", text
    ).groups()
    return int(small) if d <= 128 else int(large)


def _emulate_wgmma_bf16(q, k, v, *, causal=True, window=0):
    """The bf16 kernel instance's arithmetic in plain torch: tiles of
    ``_bf16_tile_keys(D)`` keys;
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
    tile = _bf16_tile_keys(d)
    for k0 in range(0, skv, tile):
        kt, vt = kf[:, k0 : k0 + tile], vf[:, k0 : k0 + tile]
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
        (4, 1, 128, 192, 256, 64),  # D 256 (64-key tiles), MQA, window, Sq < Skv
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


def _f32_tile_keys():
    """Keys a tile of the f32 instance: its kBn in the .cu."""
    text = CSRC.read_text().split("namespace tf32x3 {", 1)[1]
    return int(re.search(r"constexpr int kBn = (\d+);", text).group(1))


def _tf32(x, mode="trunc"):
    """float32 ``x`` reduced to tf32 on its integer view, the low 13 mantissa
    bits cleared: "trunc" drops them (what the tensor cores do with an f32
    operand: scripts/flash_f32_variants.py --probe), "rna" first rounds to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` does (a carry
    may reach the exponent).  inf and NaN pass through."""
    bits = x.view(torch.int32)
    if mode == "rna":
        bits = bits + 0x1000  # half of the dropped bits' weight, on the magnitude
    out = (bits & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _emulate_tf32x3(q, k, v, *, causal=True, window=0):
    """The f32 kernel instance's arithmetic in plain torch: tiles of
    ``_f32_tile_keys()`` keys; each f32 operand x split as hi = tf32(x) and
    lo = tf32(x - hi) (the tensor cores read an operand's tf32 part, so the
    raw tile is hi and lo's own low bits drop), a b formed as
    hi lo + lo hi + hi hi (products of tf32 parts are exact in f32; summed in
    f32, the small terms first); S = Q K^T that way, in log2 units
    (scale * log2 e); -1e30 for masked keys and as the running max's start;
    p = exp2(s - m); l summed from the f32 p; P V formed from P and V split
    the same way; the output acc / max(l, 1e-30)."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    bk = _f32_tile_keys()
    scale_log2 = d**-0.5 * 1.4426950408889634

    def split(x):
        hi = _tf32(x)
        return hi, _tf32(x - hi)

    def mm3(a, b):
        (ah, al), (bh_, bl) = split(a), split(b)
        return (ah @ bl + al @ bh_) + ah @ bh_

    kf, vf = (t.repeat_interleave(group, dim=0) for t in (k, v))
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((bh, sq, 1), -1e30)
    lsum = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, bk):
        kt, vt = kf[:, k0 : k0 + bk], vf[:, k0 : k0 + bk]
        s = mm3(q, kt.mT) * scale_log2
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
        acc = acc * corr + mm3(p, vt)
        m = m_new
    return acc / lsum.clamp_min(1e-30)


@pytest.mark.parametrize(
    "bh,bkv,sq,skv,d,window",
    [
        (2, 2, 64, 64, 32, 0),  # D 32, square
        (4, 2, 64, 128, 64, 0),  # D 64, GQA group 2, Sq < Skv
        (2, 1, 64, 64, 96, 0),  # D 96 (phi3), GQA group 2
        (4, 1, 64, 128, 128, 0),  # D 128 (qwen3), GQA group 4
        (2, 2, 128, 128, 32, 32),  # window 32
        (4, 2, 1, 256, 64, 0),  # a single decode query
        (2, 2, 48, 320, 64, 0),  # ragged: Sq < Skv, neither a block multiple
    ],
)
def test_tf32x3_f32_arithmetic_matches_flash_kernel(bh, bkv, sq, skv, d, window):
    """The 3xTF32 split on tf32 parts, the f32 instance's arithmetic, stays
    within the f32 tolerance of the Pallas kernel and the reference."""
    js, ts = _qkv(11, bh, bkv, sq, skv, d, "float32")
    got = _emulate_tf32x3(*ts, window=window)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    kw = dict(window=window) if window else {}
    _check(got, js, "float32", causal=True, **kw)


@pytest.mark.parametrize("mode", ["trunc", "rna"])
def test_tf32_rounding_helper_on_edge_values(mode):
    """Signed zeros, ties (half a tf32 ulp: away from zero under rna), a
    carry into the exponent, infinities and NaN; hi + lo == x exactly and
    |lo| within a tf32 ulp (trunc) or half of one (rna)."""
    ulp = 2.0**-10  # tf32's ulp at 1
    x = torch.tensor(
        [0.0, -0.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23,
         1 + 1.5 * ulp, 2 - 2**-23, float("inf"), float("-inf"), float("nan")],
        dtype=torch.float32,
    )
    got = _tf32(x, mode)
    if mode == "rna":
        want = [0.0, -0.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2.0]
    else:
        want = [0.0, -0.0, 1.0, -1.0, 1.0, 1 + ulp, 2 - ulp]
    want = torch.tensor(want + [float("inf"), float("-inf")], dtype=torch.float32)
    torch.testing.assert_close(got[:9], want, rtol=0, atol=0)
    assert torch.signbit(got[1]) and not torch.signbit(got[0])
    assert torch.isnan(got[9])
    assert (got[:7].view(torch.int32) & 0x1FFF == 0).all()
    r = torch.as_tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = _tf32(r, mode)
    lo = r - hi
    assert torch.equal(hi + lo, r)
    bound = (ulp if mode == "trunc" else ulp / 2) * r.abs()
    assert (lo.abs() <= bound).all()


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

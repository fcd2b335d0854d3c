"""The port's precision policy (repro_torch.core.precision and its
dtype_policy= through core.tlr and core.dist_tlr) against the JAX
reference on the CPU: the policies and their errors, f64 bit for bit the
path without a policy, the mixed_f32 storage dtypes and widening
boundaries, the mixed_f32 log-likelihood against the reference's with the
same policy, and mixed_bf16 raising on both sides."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import dist_tlr as jd  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core import tlr as jt  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import dist_tlr as td  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.distribution.block_cyclic import pair_layout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NB, KMAX, TOL, NUGGET = 48, 24, 1e-7, 1e-8
PARAMS = dict(a=0.09, nu11=0.5, nu22=1.0, beta=0.5)
# Two float32 factorizations of one matrix in another order of sums: the
# logliks agree to f32 rounding amplified by the solve, well inside 1e-6.
MIXED_PARITY = 1e-6
# The pair-major form with super-panels and column groups.
BC = dict(block_cyclic=True, super_panels=3, col_block=2)


@pytest.fixture(scope="module")
def case():
    """test_distributed.py's geometry: 144 Morton-ordered locations of a
    jittered grid, bivariate (m = 288, tile 48, T = 6), and a data vector
    made with numpy."""
    locs = grid_locations(12, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    z = np.random.default_rng(4).normal(size=2 * len(locs))
    jp = jc.MaternParams.bivariate(**PARAMS)
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    return dict(locs=locs, z=z, jp=jp, tp=tp)


def _port(case, policy, fn="tlr", **kw):
    kw.update(tol=TOL, max_rank=KMAX, tile_size=NB, nugget=NUGGET, gen="plain")
    kw.update(locs=case["locs"], from_tiles=True, dtype_policy=policy, device="cpu")
    if fn == "tlr":
        return tt.tlr_loglik(None, case["z"], case["tp"], **kw)
    return td.dist_tlr_loglik(None, case["z"], params=case["tp"], **kw)


def test_policies_and_errors_match_the_reference():
    assert sorted(tprec.POLICIES) == sorted(jprec.POLICIES)
    for name, pol in tprec.POLICIES.items():
        ref = jprec.POLICIES[name]
        fields = ("name", "wide", "narrow", "uniform")
        assert [getattr(pol, f) for f in fields] == [getattr(ref, f) for f in fields]
        assert str(pol.wide_dtype) == f"torch.{ref.wide}"
        assert str(pol.narrow_dtype) == f"torch.{ref.narrow}"
        assert tprec.resolve_policy(name) is pol
        assert tprec.resolve_policy(pol) is pol
    assert tprec.resolve_policy(None) is None
    with pytest.raises(KeyError) as got:
        tprec.resolve_policy("fp8")
    with pytest.raises(KeyError) as want:
        jprec.resolve_policy("fp8")
    assert str(got.value) == str(want.value)
    assert "mixed_bf16, mixed_f32" in str(got.value)


@pytest.mark.parametrize("fn", ["tlr", "dist_pairs"])
def test_f64_policy_is_the_path_without_a_policy_bit_for_bit(case, fn):
    kw = {} if fn == "tlr" else dict(block_cyclic=True)
    fn = "tlr" if fn == "tlr" else "dist"
    base = _port(case, None, fn, **kw)
    f64 = _port(case, "f64", fn, **kw)
    for field in ("loglik", "logdet", "quad"):
        assert torch.equal(getattr(base, field), getattr(f64, field))
    assert torch.equal(base.status.min_pivot, f64.status.min_pivot)


def test_mixed_f32_stores_uv_narrow_and_keeps_the_spine_wide(case):
    locs, tp = case["locs"], case["tp"]
    kw = dict(tile_size=NB, tol=TOL, max_rank=KMAX, nugget=NUGGET, device="cpu")
    grid = tt.tlr_compress_tiles(locs, tp, dtype_policy="mixed_f32", **kw)
    pairs = td.dist_compress_tiles(
        locs, tp, layout=pair_layout(6, 1), col_block=2, dtype_policy="mixed_f32", **kw
    )
    sigma = tc.build_sigma(locs, tp, nugget=NUGGET, device="cpu")
    dense = tt.tlr_compress(sigma, NB, TOL, KMAX, dtype_policy="mixed_f32")
    for t in (grid, pairs, dense):
        assert t.u.dtype == t.v.dtype == torch.float32
        assert t.diag.dtype == torch.float64
    # the narrow tiles are the f32 SVD of the f32 tiles: U V^T within f32
    # rounding of the wide compression's (the ranks may differ, since f32
    # singular values near the threshold tol * scale are rounding noise)
    wide = tt.tlr_compress_tiles(locs, tp, **kw)
    uv = torch.einsum("ijnk,ijmk->ijnm", grid.u.double(), grid.v.double())
    want = torch.einsum("ijnk,ijmk->ijnm", wide.u, wide.v)
    assert float((uv - want).abs().max()) <= 1e-6
    res = _port(case, "mixed_f32")
    assert res.loglik.dtype == res.logdet.dtype == torch.float64
    assert bool(res.status.ok)


def test_mixed_f32_widens_at_the_trsm_and_syrk_boundaries(case, monkeypatch):
    """The TRSM reaches the trsm kernel's f64 instance on V cast up; the
    SYRK reaches tlr_mm's f32 instance with the float64 diagonal tiles
    themselves as acc and out (the product widened in its epilogue), not a
    zero batch."""
    seen = {"trsm": set(), "tlr_mm": set()}
    trsm, tlr_mm = ops.trsm, ops.tlr_mm

    def spy_trsm(lo, b):
        seen["trsm"].add((lo.dtype, b.dtype))
        return trsm(lo, b)

    def spy_tlr_mm(u_a, v_a, u_b, v_b, acc, *, out=None):
        assert out is acc
        seen["tlr_mm"].add((u_a.dtype, acc.dtype, bool((acc == 0).all())))
        return tlr_mm(u_a, v_a, u_b, v_b, acc, out=out)

    monkeypatch.setattr(ops, "trsm", spy_trsm)
    monkeypatch.setattr(ops, "tlr_mm", spy_tlr_mm)
    _port(case, "mixed_f32")
    assert seen["trsm"] == {(torch.float64, torch.float64)}
    assert seen["tlr_mm"] == {(torch.float32, torch.float64, False)}


@pytest.fixture(scope="module")
def reference_mixed(case):
    """The reference's mixed_f32 logliks: tlr_loglik and dist_tlr_loglik
    (masked grid, and pair-major with super-panels and column groups)."""
    args = dict(tol=TOL, max_rank=KMAX, tile_size=NB, nugget=NUGGET, gen="xla")
    args["dtype_policy"] = "mixed_f32"
    jp = case["jp"]

    @partial(jax.jit, static_argnames=("kind",))
    def run(locs, z, kind):
        if kind == "tlr":
            res = jt.tlr_loglik(None, z, jp, locs=locs, from_tiles=True, **args)
        else:
            kw = BC if kind == "bc" else {}
            res = jd.dist_tlr_loglik(
                None, z, locs=locs, params=jp, from_tiles=True, **args, **kw
            )
        return res.loglik

    data = (jnp.asarray(case["locs"]), jnp.asarray(case["z"]))
    return {kind: float(run(*data, kind)) for kind in ("tlr", "masked", "bc")}


@pytest.mark.parametrize("kind", ["tlr", "masked", "bc"])
def test_mixed_f32_loglik_matches_the_reference(case, reference_mixed, kind):
    if kind == "tlr":
        got = _port(case, "mixed_f32")
    elif kind == "masked":
        got = _port(case, "mixed_f32", "dist")
    else:
        got = _port(case, "mixed_f32", "dist", **BC)
    want = reference_mixed[kind]
    assert float(got.loglik) == pytest.approx(want, rel=MIXED_PARITY)
    # and the policy moved the value off the f64 one by more than rounding
    assert float(got.loglik) != float(_port(case, None).loglik)


def test_mixed_bf16_raises_on_both_sides(case):
    """torch.linalg and jnp.linalg have no bfloat16 SVD or QR on the CPU:
    the compression's truncation SVD raises on both sides."""
    kw = dict(tile_size=NB, tol=TOL, max_rank=KMAX, nugget=NUGGET)
    with pytest.raises(NotImplementedError):
        tt.tlr_compress_tiles(
            case["locs"], case["tp"], dtype_policy="mixed_bf16", device="cpu", **kw
        )
    with pytest.raises(NotImplementedError):
        jkw = dict(kw, gen="xla", dtype_policy="mixed_bf16")
        jt.tlr_compress_tiles(jnp.asarray(case["locs"]), case["jp"], **jkw)
    with pytest.raises(NotImplementedError):
        _port(case, "mixed_bf16", "dist", block_cyclic=True)

"""The port's kernel layer on the CPU.

The plain versions (repro_torch.kernels.ref) against the Pallas kernels run
in interpret mode, at the tolerances of tests/test_kernels.py; the dispatch
(repro_torch.kernels.ops) takes the plain version for CPU tensors without
counting a launch; the CUDA wrappers refuse what their kernels do not take.
The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py.
"""

import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import matern as jm  # noqa: E402
from repro.kernels.matern_tile import matern_tile as j_matern_tile  # noqa: E402
from repro.kernels.tlr_mm import tlr_mm as j_tlr_mm  # noqa: E402
from repro_torch.kernels import _build, matern_tile, ops, ref  # noqa: E402
from repro_torch.kernels.chol_tiles import (  # noqa: E402
    potrf_cuda,
    potrf_instance,
    syrk_cuda,
    syrk_instance,
    trsm_cuda,
    trsm_instance,
)
from repro_torch.kernels.matern_corr import matern_corr_cuda  # noqa: E402
from repro_torch.kernels.matern_tile import matern_tile_cuda  # noqa: E402
from repro_torch.kernels.tlr_mm import check_out, tlr_mm_cuda  # noqa: E402
from repro_torch.kernels.tlr_mm import instance as tlr_mm_instance  # noqa: E402

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "float64": (jnp.float64, torch.float64),
}


def _tol(name):
    # as tests/test_kernels.py::_tol
    if name == "float32":
        return dict(rtol=2e-3, atol=1e-3)
    return dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_matern_tile_ref_matches_pallas(nu, dname):
    jdt, tdt = DTYPES[dname]
    rng = np.random.default_rng(0)
    la, lb = rng.uniform(size=(64, 2)), rng.uniform(size=(48, 2))
    want = j_matern_tile(
        jnp.asarray(la, jdt),
        jnp.asarray(lb, jdt),
        1.0 / 0.1,
        1.3,
        nu=nu,
        block_n=64,
        block_m=48,
        interpret=True,
    )
    la_t, lb_t = torch.as_tensor(la, dtype=tdt), torch.as_tensor(lb, dtype=tdt)
    got = ref.matern_tile_ref(la_t, lb_t, 1.0 / 0.1, 1.3, nu)
    assert got.dtype == tdt and got.shape == (64, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dname))


@pytest.mark.parametrize("nu", [0.73, 1.0, 2.283])
def test_matern_tile_ref_general_orders_match_jax(nu):
    """Orders the Pallas kernel does not take: the plain version against the
    reference's correlation of the same distances, at u up to about 40, with
    coincident points (M(0) = 1)."""
    rng = np.random.default_rng(9)
    la = rng.uniform(size=(40, 2))
    lb = np.concatenate([la[:3], rng.uniform(size=(21, 2))])
    inv_range, amp = 1.0 / 0.03, 1.3
    got = ref.matern_tile_ref(
        torch.as_tensor(la), torch.as_tensor(lb), inv_range, amp, nu
    ).numpy()
    u = jc.pairwise_distances(jnp.asarray(la), jnp.asarray(lb)) * inv_range
    want = amp * np.asarray(jm.matern_correlation(u, nu))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=0.0)
    np.testing.assert_array_equal(np.diagonal(got[:3, :3]), amp)


def test_matern_launch_args_pick_the_instance_and_refuse_bad_orders():
    """The order alone picks the instance (a float or a 0-d tensor); the
    general instance gets the host array of its order; orders that are not
    finite and > 0 are refused before anything is built."""
    for nu in (0.5, 1.5, 2.5, torch.tensor(1.5, dtype=torch.float64)):
        assert matern_tile.launch_args(nu) == ("halfint", round(2 * float(nu)), None)
    for nu in (1.0, 0.73, 3.0, torch.tensor(1.0, dtype=torch.float64)):
        name, nu2, ptr = matern_tile.launch_args(nu)
        assert (name, nu2) == ("general", 0)
        assert ptr == matern_tile.general_args(float(nu)).ctypes.data
    for bad in (0.0, -0.5, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite and > 0"):
            matern_tile.instance(bad)
    assert set(matern_tile_cuda.launches_by_instance) == {"halfint", "general"}
    assert set(matern_corr_cuda.launches_by_instance) == {"halfint", "general"}
    matern_tile_cuda.launches_by_instance["general"] = 2
    matern_corr_cuda.launches_by_instance["halfint"] = 1
    ops.reset_launch_counts()
    counts = ops.instance_counts()
    for name in ("matern_tile", "matern_corr"):
        assert counts[name] == {"halfint": 0, "general": 0}


def test_matern_tile_ref_ragged_and_coincident_points():
    """A ragged shape (the TPU kernel rounds its blocks to divisors; the CUDA
    kernel masks the edge) with coincident points, where M(0) = 1."""
    rng = np.random.default_rng(8)
    la = rng.uniform(size=(96, 2))
    lb = np.concatenate([la[:5], rng.uniform(size=(35, 2))])
    want = j_matern_tile(
        jnp.asarray(la),
        jnp.asarray(lb),
        1.0 / 0.1,
        1.0,
        nu=1.5,
        block_n=64,
        block_m=64,
        interpret=True,
    )
    got = ref.matern_tile_ref(
        torch.as_tensor(la), torch.as_tensor(lb), 1.0 / 0.1, 1.0, 1.5
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(np.diagonal(got[:5, :5]), 1.0)


@pytest.mark.parametrize("b,nb,k", [(1, 64, 8), (4, 40, 16), (3, 64, 32)])
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_tlr_mm_ref_matches_pallas(b, nb, k, dname):
    jdt, tdt = DTYPES[dname]
    rng = np.random.default_rng(1)
    ua, va, ub, vb = (rng.normal(size=(b, nb, k)) for _ in range(4))
    acc = rng.normal(size=(b, nb, nb))
    args = (ua, va, ub, vb, acc)
    want = j_tlr_mm(*(jnp.asarray(x, jdt) for x in args), interpret=True)
    got = ref.tlr_mm_ref(*(torch.as_tensor(x, dtype=tdt) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dname))


def test_tlr_mm_ref_padded_rank_columns_are_inert():
    rng = np.random.default_rng(2)
    b, nb, k = 2, 64, 16
    ua, va, ub, vb = (rng.normal(size=(b, nb, k)) for _ in range(4))
    for arr in (ua, va, ub, vb):
        arr[:, :, k // 2 :] = 0.0
    acc = rng.normal(size=(b, nb, nb))
    short = [x[:, :, : k // 2] for x in (ua, va, ub, vb)]
    got = ref.tlr_mm_ref(*(torch.as_tensor(x) for x in (ua, va, ub, vb, acc)))
    want = j_tlr_mm(*(jnp.asarray(x) for x in short + [acc]), interpret=True)
    plain = ref.tlr_mm_ref(*(torch.as_tensor(x) for x in short + [acc]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-10)


def test_ops_on_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    la = torch.as_tensor(rng.uniform(size=(20, 2)))
    lb = torch.as_tensor(rng.uniform(size=(9, 2)))
    got = ops.matern_tile(la, lb, 5.0, 2.0, nu=2.5)
    want = ref.matern_tile_ref(la, lb, 5.0, 2.0, 2.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    u, v = (torch.as_tensor(rng.normal(size=(3, 16, 4))) for _ in range(2))
    acc = torch.as_tensor(rng.normal(size=(3, 16, 16)))
    got = ops.tlr_mm(u, v, u, v, acc)
    np.testing.assert_array_equal(got.numpy(), ref.tlr_mm_ref(u, v, u, v, acc))
    spd = acc @ acc.mT + 16 * torch.eye(16, dtype=acc.dtype)
    lo = ops.potrf(spd)
    np.testing.assert_array_equal(lo.numpy(), ref.potrf_ref(spd).numpy())
    np.testing.assert_array_equal(ops.trsm(lo, u).numpy(), ref.trsm_ref(lo, u).numpy())
    got = ops.syrk(acc, u)
    np.testing.assert_array_equal(got.numpy(), ref.syrk_ref(acc, u).numpy())
    dists = torch.as_tensor(rng.uniform(0.0, 3.0, size=(7, 5)))
    for nu in (1.5, 1.0):
        got = ops.matern_correlation(dists, nu, amp=0.5)
        want = ref.matern_corr_ref(dists, 0.5, nu)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ops.launch_counts() == {
        "matern_tile": 0,
        "matern_corr": 0,
        "tlr_mm": 0,
        "potrf": 0,
        "trsm": 0,
        "syrk": 0,
        "flash_attention": 0,
    }


def test_ops_refuse_devices_without_a_kernel():
    la = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.matern_tile(la, la, 1.0, 1.0, nu=0.5)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.matern_correlation(la, 1.0)


def test_cuda_wrappers_refuse_cpu_tensors_before_building():
    la = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        matern_tile_cuda(la, la, 1.0, 1.0, nu=1.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        matern_tile_cuda(la, la, 1.0, 1.0, nu=1.0)
    for bad in (0.0, float("nan")):
        with pytest.raises(ValueError, match="finite and > 0"):
            matern_tile_cuda(la, la, 1.0, 1.0, nu=bad)
        with pytest.raises(ValueError, match="finite and > 0"):
            matern_corr_cuda(la, 1.0, nu=bad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        matern_corr_cuda(la, 1.0, nu=0.73)
    u = torch.zeros((2, 8, 4), dtype=torch.float64)
    acc = torch.zeros((2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlr_mm_cuda(u, u, u, u, acc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        potrf_cuda(acc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trsm_cuda(acc, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        syrk_cuda(acc, u)
    assert ops.launch_counts() == {
        "matern_tile": 0,
        "matern_corr": 0,
        "tlr_mm": 0,
        "potrf": 0,
        "trsm": 0,
        "syrk": 0,
        "flash_attention": 0,
    }


def test_build_hash_follows_the_sources_and_raises_without_nvcc(tmp_path, monkeypatch):
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert {p.name for p in sources} == {
        "flash_attention.cu",
        "matern_corr.cu",
        "matern_tile.cu",
        "potrf.cu",
        "syrk.cu",
        "tlr_mm.cu",
        "trsm.cu",
    }
    copy = tmp_path / sources[0].name
    copy.write_bytes(sources[0].read_bytes() + b"\n")
    assert _build._digest(sources) != _build._digest([copy] + sources[1:])
    if shutil.which("nvcc") is None:
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()
        assert not (tmp_path / "build").exists()


# The f64 instance of the CUDA tlr_mm (csrc/tlr_mm.cu, dmma_f64): rows of a
# strip, columns of an output chunk, and rank columns of a pass.
STRIP, RANK_PASS = 64, 128


def _emulate_tlr_mm_dmma_f64(ua, va, ub, vb, acc):
    """The dmma_f64 tlr_mm instance's order of work in plain torch: W = V_a^T
    V_b; then per 64-row strip and per pass of 128 rank columns, T = U_a
    W[:, pass] formed once, and out[strip, chunk] = src - T U_b[chunk,
    pass]^T for 64-column chunks, src being acc in the first pass and out
    after it."""
    b, nb, k = ua.shape
    w = va.mT @ vb
    out = torch.empty_like(acc)
    for r0 in range(0, nb, STRIP):
        rs = slice(r0, r0 + STRIP)
        for p0 in range(0, k, RANK_PASS):
            ps = slice(p0, p0 + RANK_PASS)
            t = ua[:, rs] @ w[:, :, ps]
            src = acc if p0 == 0 else out
            for c0 in range(0, nb, STRIP):
                cs = slice(c0, c0 + STRIP)
                out[:, rs, cs] = src[:, rs, cs] - t @ ub[:, cs, ps].mT
    return out


@pytest.mark.parametrize(
    "b,nb,k,padded",
    [
        (1, 64, 8, False),
        (4, 40, 16, False),
        (3, 64, 32, False),
        (2, 130, 16, True),  # a ragged strip and chunk, half the rank zero
        (2, 70, 200, False),  # two rank passes
    ],
)
def test_dmma_tlr_mm_order_of_work_matches_pallas(b, nb, k, padded):
    """The f64 CUDA instance's order of work against the Pallas tlr_mm in
    interpret mode, at the tolerance of test_tlr_mm_ref_matches_pallas;
    zero-padded rank columns add exact zeros (the result equals the one
    from the unpadded factors to rounding)."""
    rng = np.random.default_rng(6)
    ua, va, ub, vb = (rng.normal(size=(b, nb, k)) for _ in range(4))
    if padded:
        for arr in (ua, va, ub, vb):
            arr[:, :, k // 2 :] = 0.0
    acc = rng.normal(size=(b, nb, nb))
    args = (ua, va, ub, vb, acc)
    got = _emulate_tlr_mm_dmma_f64(*(torch.as_tensor(x) for x in args))
    want = j_tlr_mm(*(jnp.asarray(x) for x in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("float64"))
    if padded:
        short = [torch.as_tensor(x[:, :, : k // 2]) for x in (ua, va, ub, vb)]
        plain = ref.tlr_mm_ref(*short, torch.as_tensor(acc))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **_tol("float64"))


# The f32 instance of the CUDA tlr_mm (csrc/tlr_mm.cu, fma_f32): stage 1
# cuts nb into at most kFSplitMax slices of at least kFSliceMin rows, each a
# multiple of the kFWRows-row chunk; the constants are read from the source.
def _fma_f32_constant(name):
    text = (_build.CSRC / "tlr_mm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _fma_f32_slices(nb):
    split_max, slice_min, chunk = (
        _fma_f32_constant(n) for n in ("kFSplitMax", "kFSliceMin", "kFWRows")
    )
    splits = min(split_max, -(-nb // slice_min))
    per = -(-nb // splits)
    rows = -(-per // chunk) * chunk
    return [(s * rows, min(nb, (s + 1) * rows)) for s in range(splits)]


def _emulate_tlr_mm_fma_f32(ua, va, ub, vb, acc):
    """The fma_f32 tlr_mm instance's order of work in plain f32 torch: W =
    V_a^T V_b as the sum of its slices' partials in slice order (an empty
    slice adds zeros); T = U_a W, rounded to f32; then out[strip, chunk] =
    acc - T U_b^T by 64 x 64 tiles, the f32 product widened when acc is
    float64."""
    b, nb, k = ua.shape
    w = torch.zeros((b, k, k), dtype=torch.float32)
    for n0, n1 in _fma_f32_slices(nb):
        w = w + va[:, n0:n1].mT @ vb[:, n0:n1]
    t = ua @ w
    out = torch.empty_like(acc)
    for r0 in range(0, nb, STRIP):
        rs = slice(r0, r0 + STRIP)
        for c0 in range(0, nb, STRIP):
            cs = slice(c0, c0 + STRIP)
            out[:, rs, cs] = acc[:, rs, cs] - t[:, rs] @ ub[:, cs].mT
    return out


@pytest.mark.parametrize(
    "b,nb,k,padded",
    [
        (1, 64, 8, False),
        (4, 40, 16, False),
        (3, 64, 32, False),
        (2, 130, 16, True),  # three slices, a ragged tile, half the rank zero
        (2, 70, 200, False),  # two slices, k past 128
        (1, 512, 8, False),  # the path's nb: eight slices of 64 rows
        (1, 301, 8, False),  # the ragged nb: five slices, the last short
        (1, 520, 8, False),  # eight 96-row slices: the last two empty
    ],
)
def test_fma_f32_tlr_mm_order_of_work_matches_pallas(b, nb, k, padded):
    """The f32 CUDA instance's order of work against the Pallas tlr_mm in
    interpret mode, in float32, at the tolerance of
    test_tlr_mm_ref_matches_pallas; its W slices cover nb in order, one
    after another (an empty one at the end adds zeros); zero-padded rank
    columns add exact zeros."""
    slices = _fma_f32_slices(nb)
    assert slices[0][0] == 0 and max(n1 for _, n1 in slices) == nb
    assert all(n0 == prev_n1 for (_, prev_n1), (n0, _) in zip(slices, slices[1:])
               if n0 < nb)
    assert len(slices) <= 8 and all(n1 - n0 >= 64 or n1 == nb for n0, n1 in slices)
    rng = np.random.default_rng(9)
    ua, va, ub, vb = (rng.normal(size=(b, nb, k)) for _ in range(4))
    if padded:
        for arr in (ua, va, ub, vb):
            arr[:, :, k // 2 :] = 0.0
    acc = rng.normal(size=(b, nb, nb))
    args = [x.astype(np.float32) for x in (ua, va, ub, vb, acc)]
    got = _emulate_tlr_mm_fma_f32(*(torch.as_tensor(x) for x in args))
    want = j_tlr_mm(*(jnp.asarray(x) for x in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("float32"))
    if padded:
        short = [torch.as_tensor(x[:, :, : k // 2]) for x in args[:4]]
        plain = ref.tlr_mm_ref(*short, torch.as_tensor(args[4]))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **_tol("float32"))


def test_ops_tlr_mm_widens_f32_factors_into_a_float64_acc_as_the_two_step_form():
    """f32 factors with a float64 acc (the mixed SYRK): in place, bit for bit
    the f32 form into a zero batch, widened and added, as the path computed
    it before; the instance's order of work gives the same; and within the
    f32 tolerance of the reference's SYRK, diag - upd with jnp promoting."""
    rng = np.random.default_rng(8)
    u, v = (torch.as_tensor(rng.normal(size=(3, 24, 5)), dtype=torch.float32)
            for _ in range(2))
    diag = torch.as_tensor(rng.normal(size=(5, 24, 24)))
    neg = torch.zeros((3, 24, 24), dtype=torch.float32)
    ops.tlr_mm(u, v, u, v, neg, out=neg)
    want = diag[2:] + neg.to(torch.float64)
    before = diag.clone()
    got = ops.tlr_mm(u, v, u, v, diag[2:], out=diag[2:])
    assert got.data_ptr() == diag[2:].data_ptr() and got.dtype == torch.float64
    assert torch.equal(diag[2:], want)
    assert torch.equal(diag[:2], before[:2])
    emulated = _emulate_tlr_mm_fma_f32(u, v, u, v, before[2:])
    assert emulated.dtype == torch.float64
    np.testing.assert_allclose(emulated.numpy(), want.numpy(), **_tol("float32"))
    un, vn = u.numpy(), v.numpy()
    w = jnp.einsum("tnk,tnl->tkl", vn, vn)
    upd = jnp.einsum("tnk,tkl,tml->tnm", un, w, un)
    reference = jnp.asarray(before[2:].numpy()) - upd
    assert reference.dtype == jnp.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(reference), **_tol("float32"))


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_ops_tlr_mm_in_place_equals_out_of_place_and_writes_acc(dname):
    _, tdt = DTYPES[dname]
    rng = np.random.default_rng(7)
    u, v = (torch.as_tensor(rng.normal(size=(3, 24, 5)), dtype=tdt) for _ in range(2))
    diag = torch.as_tensor(rng.normal(size=(5, 24, 24)), dtype=tdt)
    want = ops.tlr_mm(u, v, u, v, diag[2:])
    before = diag.clone()
    got = ops.tlr_mm(u, v, u, v, diag[2:], out=diag[2:])
    assert got.data_ptr() == diag[2:].data_ptr()
    np.testing.assert_array_equal(diag[2:].numpy(), want.numpy())
    np.testing.assert_array_equal(diag[:2].numpy(), before[:2].numpy())
    other = torch.empty_like(want)
    assert ops.tlr_mm(u, v, u, v, before[2:], out=other) is other
    np.testing.assert_array_equal(other.numpy(), want.numpy())


def test_tlr_mm_out_refuses_overlap_other_than_acc_itself():
    u = torch.zeros((2, 8, 4), dtype=torch.float64)
    big = torch.zeros((4, 8, 8), dtype=torch.float64)
    acc, v = big[:2], big[2:]
    with pytest.raises(ValueError, match="out overlaps u_a"):
        check_out(acc, v, [("u_a", acc.reshape(2, 16, 4))])
    with pytest.raises(ValueError, match="out must match acc"):
        ops.tlr_mm(u, u, u, u, acc, out=torch.zeros((2, 8, 8), dtype=torch.float32))
    check_out(acc, acc, [("u_a", u)])  # out = acc is the in-place form


def test_potrf_and_tlr_mm_wrappers_refuse_without_building(monkeypatch):
    """CPU tensors, dtypes without an instance and overlapping ``out`` are
    refused before the library is built; each dtype names its instance, for
    potrf, tlr_mm, trsm and syrk alike, and the counts by instance reset.
    tlr_mm takes three dtype pairs (factors, acc): all float64, all
    float32, and float32 factors with a float64 acc; it refuses every other
    mix."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built the library"))
    for fn in (potrf_cuda, tlr_mm_cuda, trsm_cuda, syrk_cuda):
        assert set(fn.launches_by_instance) == {"dmma_f64", "fma_f32"}
    for pick in (potrf_instance, trsm_instance, syrk_instance):
        assert pick(torch.float64) == "dmma_f64"
        assert pick(torch.float32) == "fma_f32"
        for dtype in (torch.float16, torch.bfloat16, torch.int32):
            with pytest.raises(ValueError, match="float32 or float64"):
                pick(dtype)
    assert tlr_mm_instance(torch.float64) == "dmma_f64"
    assert tlr_mm_instance(torch.float32) == "fma_f32"
    assert tlr_mm_instance(torch.float32, torch.float64) == "fma_f32"
    # the wide acc is the one mix: every other pair is refused
    mixes = [(torch.float64, torch.float32), (torch.float32, torch.float16),
             (torch.bfloat16, torch.float64), (torch.float16, torch.float32),
             (torch.float64, torch.bfloat16)]
    for factors, acc_dtype in mixes:
        with pytest.raises(ValueError, match="float32 or float64"):
            tlr_mm_instance(factors, acc_dtype)
        u = torch.zeros((2, 8, 4), dtype=factors)
        acc = torch.zeros((2, 8, 8), dtype=acc_dtype)
        with pytest.raises(ValueError, match="float32 or float64"):
            tlr_mm_cuda(u, u, u, u, acc)
        with pytest.raises(ValueError, match="float32 or float64"):
            tlr_mm_cuda(u, u, u, u, acc, out=acc)
    u32 = torch.zeros((2, 8, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlr_mm_cuda(u32, u32, u32, u32, torch.zeros((2, 8, 8), dtype=torch.float64))
    for dtype in (torch.float64, torch.float16, torch.int32):
        u = torch.zeros((2, 8, 4), dtype=dtype)
        acc = torch.zeros((2, 8, 8), dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensor|float32 or float64"):
            potrf_cuda(acc)
        with pytest.raises(ValueError, match="CUDA tensor|float32 or float64"):
            tlr_mm_cuda(u, u, u, u, acc)
        with pytest.raises(ValueError, match="CUDA tensor|float32 or float64"):
            tlr_mm_cuda(u, u, u, u, acc, out=acc)
        with pytest.raises(ValueError, match="CUDA tensor|float32 or float64"):
            trsm_cuda(acc, u)
        with pytest.raises(ValueError, match="CUDA tensor|float32 or float64"):
            syrk_cuda(acc, u)
    big = torch.zeros((4, 8, 8), dtype=torch.float64)
    u = torch.zeros((2, 8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="out overlaps acc"):
        ops.tlr_mm(u, u, u, u, big[:2], out=big[1:3])
    counts = ops.launch_counts()
    assert all(counts[name] == 0 for name in ("potrf", "tlr_mm", "trsm", "syrk"))
    potrf_cuda.launches_by_instance["dmma_f64"] = 2
    tlr_mm_cuda.launches_by_instance["fma_f32"] = 1
    trsm_cuda.launches_by_instance["dmma_f64"] = 3
    syrk_cuda.launches_by_instance["fma_f32"] = 4
    ops.reset_launch_counts()
    counts = ops.instance_counts()
    for name in ("potrf", "tlr_mm", "trsm", "syrk"):
        assert counts[name] == {"dmma_f64": 0, "fma_f32": 0}
    assert counts["flash_attention"] == {"wgmma_bf16": 0, "tf32x3_f32": 0}

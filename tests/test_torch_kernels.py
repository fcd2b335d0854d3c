"""The port's kernel layer on the CPU.

The plain versions (repro_torch.kernels.ref) against the Pallas kernels run
in interpret mode, at the tolerances of tests/test_kernels.py; the dispatch
(repro_torch.kernels.ops) takes the plain version for CPU tensors without
counting a launch; the CUDA wrappers refuse what their kernels do not take.
The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matern_tile import matern_tile as j_matern_tile  # noqa: E402
from repro.kernels.tlr_mm import tlr_mm as j_tlr_mm  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.chol_tiles import (  # noqa: E402
    potrf_cuda,
    syrk_cuda,
    trsm_cuda,
)
from repro_torch.kernels.matern_tile import matern_tile_cuda  # noqa: E402
from repro_torch.kernels.tlr_mm import tlr_mm_cuda  # noqa: E402

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
    assert ops.launch_counts() == {
        "matern_tile": 0,
        "tlr_mm": 0,
        "potrf": 0,
        "trsm": 0,
        "syrk": 0,
    }


def test_ops_refuse_devices_without_a_kernel():
    la = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.matern_tile(la, la, 1.0, 1.0, nu=0.5)


def test_cuda_wrappers_refuse_cpu_tensors_before_building():
    la = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        matern_tile_cuda(la, la, 1.0, 1.0, nu=1.5)
    with pytest.raises(ValueError, match="supports nu"):
        matern_tile_cuda(la, la, 1.0, 1.0, nu=1.0)
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
        "tlr_mm": 0,
        "potrf": 0,
        "trsm": 0,
        "syrk": 0,
    }


def test_build_hash_follows_the_sources_and_raises_without_nvcc(tmp_path, monkeypatch):
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert {p.name for p in sources} == {
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

"""The POTRF and TRSM tile tasks of the port on the CPU.

The plain versions (repro_torch.kernels.ref.potrf_ref / trsm_ref) against
the Pallas kernels run in interpret mode and against the reference's own
plain versions, at the shapes and tolerances of tests/test_kernels.py; the
failure rule (a tile with a bad pivot comes back all NaN and the status is
not ok); the block-column choice of the CUDA trsm; and that the TLR path
reaches both tasks through kernels.ops.  The CUDA kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chol_tiles import potrf as j_potrf  # noqa: E402
from repro.kernels.chol_tiles import trsm as j_trsm  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.recovery import init_status  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.chol_tiles import trsm_cols  # noqa: E402

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "float64": (jnp.float64, torch.float64),
}
# as tests/test_kernels.py::test_potrf_kernel and ::test_trsm_kernel
POTRF_TOL = {
    "float32": dict(rtol=5e-4, atol=5e-4),
    "float64": dict(rtol=1e-9, atol=1e-11),
}
TRSM_TOL = {
    "float32": dict(rtol=1e-3, atol=1e-3),
    "float64": dict(rtol=1e-9, atol=1e-11),
}
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def _spd_batch(b, nb, seed=0):
    """a a^T + nb I, as tests/test_kernels.py::_spd_batch."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, nb, nb))
    return a @ np.swapaxes(a, -1, -2) + nb * np.eye(nb)


@pytest.mark.parametrize("b,nb", [(1, 32), (4, 64), (2, 128)])
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_potrf_ref_matches_pallas(b, nb, dname):
    jd, td = DTYPES[dname]
    a = _spd_batch(b, nb)
    got = ref.potrf_ref(torch.as_tensor(a, dtype=td)).numpy()
    want = np.asarray(j_potrf(jnp.asarray(a, jd), interpret=True))
    np.testing.assert_allclose(got, want, **POTRF_TOL[dname])
    plain = np.asarray(jref.potrf_ref(jnp.asarray(a, jd)))
    np.testing.assert_allclose(got, plain, **POTRF_TOL[dname])
    assert np.all(np.triu(got, 1) == 0.0)


@pytest.mark.parametrize("b,nb,m", [(1, 32, 32), (3, 64, 16), (2, 64, 128)])
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_trsm_ref_matches_pallas(b, nb, m, dname):
    jd, td = DTYPES[dname]
    lo = np.linalg.cholesky(_spd_batch(b, nb))
    bb = np.random.default_rng(3).normal(size=(b, nb, m))
    got = ref.trsm_ref(torch.as_tensor(lo, dtype=td), torch.as_tensor(bb, dtype=td))
    want = j_trsm(jnp.asarray(lo, jd), jnp.asarray(bb, jd), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRSM_TOL[dname])
    plain = jref.trsm_ref(jnp.asarray(lo, jd), jnp.asarray(bb, jd))
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), **TRSM_TOL[dname])


def test_trsm_broadcasts_one_factor_over_the_batch():
    """The panel TRSM form: one L_kk for every live row of the column."""
    lo = torch.as_tensor(np.linalg.cholesky(_spd_batch(1, 48)))
    bb = torch.as_tensor(np.random.default_rng(4).normal(size=(5, 48, 7)))
    got = ops.trsm(lo, bb)
    want = ref.trsm_ref(lo.expand(5, 48, 48), bb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose((lo @ got).numpy(), bb.numpy(), rtol=1e-10, atol=1e-10)


def test_non_spd_tile_gives_nan_tile_and_bad_status_as_in_jax():
    a = _spd_batch(3, 32)
    a[1] -= 1e4 * np.eye(32)  # indefinite
    got = ops.potrf(torch.as_tensor(a))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    # the whole tile is NaN; the reference leaves zeros above the diagonal
    lower = np.tril_indices(32)
    assert np.all(np.isnan(got[1].numpy())) and np.all(np.isnan(want[1][lower]))
    for t in (0, 2):
        np.testing.assert_allclose(got[t].numpy(), want[t], rtol=1e-10, atol=1e-12)
    assert not bool(init_status(torch.float64, "cpu").update_potrf(got).ok)
    assert bool(init_status(torch.float64, "cpu").update_potrf(got[::2]).ok)


def test_nonfinite_pivot_tile_is_nan():
    """A pivot that is not finite fails the tile, as in the CUDA kernel."""
    a = _spd_batch(2, 16)
    a[0, 5, 5] = math.inf
    a[1, 3, 2] = math.nan
    got = ref.potrf_ref(torch.as_tensor(a))
    assert torch.isnan(got).all()


def test_tile_cholesky_composition():
    """POTRF + TRSM (+ the dense SYRK) compose into a 2x2-block factor."""
    nb = 64
    a = _spd_batch(1, 2 * nb)[0]
    a11, a21, a22 = a[:nb, :nb], a[nb:, :nb], a[nb:, nb:]
    l11 = ops.potrf(torch.as_tensor(a11)[None])
    l21 = ops.trsm(l11, torch.as_tensor(a21.T)[None])[0].mT
    l22 = ops.potrf((torch.as_tensor(a22) - l21 @ l21.mT)[None])[0]
    lo = torch.zeros((2 * nb, 2 * nb), dtype=torch.float64)
    lo[:nb, :nb], lo[nb:, :nb], lo[nb:, nb:] = l11[0], l21, l22
    np.testing.assert_allclose((lo @ lo.mT).numpy(), a, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize(
    "nb,r,batch,itemsize,want",
    [
        (512, 128, 63, 8, 32),  # panel TRSM of the main path
        (512, 1, 1, 8, 1),  # forward sweep for alpha
        (512, 1024, 1, 8, 8),  # a predict batch: more blocks for the SMs
        (2048, 128, 63, 8, 8),  # the README's serving tile: shared memory
        (2048, 128, 63, 4, 16),
        (40, 3, 2, 8, 4),
    ],
)
def test_trsm_block_columns(nb, r, batch, itemsize, want):
    rc = trsm_cols(nb, r, batch, itemsize, H100_SMS)
    assert rc == want
    assert nb * rc * itemsize <= 200 * 1024


def test_trsm_block_columns_refuse_a_column_too_tall():
    with pytest.raises(ValueError, match="shared memory"):
        trsm_cols(40000, 1, 1, 8, H100_SMS)


def test_tlr_path_runs_potrf_and_trsm_through_ops(monkeypatch):
    """Every POTRF and TRSM task of slice 1's grid path goes to kernels.ops
    (on the card: the CUDA kernels); counted with spies on the CPU."""
    calls = {"potrf": [], "trsm": []}
    for name in calls:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name):
            calls[_name].append(tuple(args[-1].shape))
            return _real(*args)

        monkeypatch.setattr(ops, name, spy)
    T, nb = 4, 16
    rng = np.random.default_rng(5)
    sigma = torch.as_tensor(_spd_batch(1, T * nb)[0] / (T * nb))
    t = tt.tlr_compress(sigma, tile_size=nb, tol=1e-12, max_rank=nb)
    chol = tt.tlr_cholesky(t, tol=1e-12)
    assert len(calls["potrf"]) == T
    assert calls["trsm"] == [(T - 1 - k, nb, nb) for k in range(T - 1)]
    z = torch.as_tensor(rng.normal(size=T * nb))
    alpha = tt.tlr_solve_lower(chol, z)
    assert len(calls["trsm"]) == (T - 1) + T
    dense = torch.linalg.cholesky(sigma)
    want = torch.linalg.solve_triangular(dense, z[:, None], upper=False)[:, 0]
    np.testing.assert_allclose(alpha.numpy(), want.numpy(), rtol=1e-8, atol=1e-8)


# The f64 instance of the CUDA potrf (csrc/potrf.cu, dmma_f64): its panel
# width, which is also the largest edge of a trailing-update tile, and the
# half panel that one warp factors.
PANEL, HALF = 64, 32


def _factor_block(d, sinv, o):
    """The kernel's warp-level factor of d[o:o+32, o:o+32], in place,
    right-looking a pivot at a time: the reciprocal square root r of the
    pivot p, the diagonal p r, the column below scaled by r, then
    x[i][l] -= L[i][c] L[l][c].  Returns False on a pivot that is not
    positive and finite."""
    n = HALF
    blk = d[o : o + n, o : o + n]
    idx = torch.arange(n)
    for c in range(n):
        p = blk[c, c].clone()
        if not (bool(p > 0) and bool(torch.isfinite(p))):
            return False
        rinv = torch.rsqrt(p)
        sinv[o + c] = rinv
        col = torch.where(idx > c, blk[:, c] * rinv, torch.zeros_like(p))
        col[c] = p * rinv
        blk[:, c] = col
        upd = col[:, None] * col[None, :]
        keep = (idx[None, :] > c) & (idx[None, :] <= idx[:, None])
        blk.copy_(torch.where(keep, blk - upd, blk))
    return True


def _solve_rows(y, lo, sinv):
    """y <- y L^{-T} row by row, right-looking: y[c] *= 1 / L[c][c], then
    y[l] -= y[c] L[l][c] for l > c."""
    for c in range(lo.shape[0]):
        y[:, c] = y[:, c] * sinv[c]
        y[:, c + 1 :] -= y[:, c : c + 1] * lo[c + 1 :, c][None, :]
    return y


def _emulate_potrf_dmma_f64(a):
    """The dmma_f64 potrf instance's order of work in plain torch, in a's
    dtype.

    Per panel of 64 columns: the diagonal block, padded with the identity to
    64, factored as the kernel's panel block does (the first 32 columns by
    one warp, the rows below them solved, the rank-32 update of the second
    half, which runs on DMMA, then its 32 columns); the rows below the panel
    solved against it; then the trailing lower triangle updated one 64 x 64
    tile at a time (the DMMA product; on the card the tiles are 32 x 32 while
    the 64 x 64 ones would fill under two waves, the same sums).  A pivot
    that is not positive and finite sets the tile's flag, ends its steps, and
    the tile comes back all NaN.
    """
    b, nb, _ = a.shape
    out = torch.tril(a).clone()
    rows = torch.arange(nb)[:, None]
    cols = torch.arange(nb)[None, :]
    flag = torch.zeros(b, dtype=torch.bool)
    for t in range(b):
        lo = out[t]
        for j0 in range(0, nb, PANEL):
            w = min(PANEL, nb - j0)
            t0 = j0 + w
            d = torch.eye(PANEL, dtype=a.dtype)
            d[:w, :w] = lo[j0:t0, j0:t0]
            sinv = torch.empty(PANEL, dtype=a.dtype)
            if not _factor_block(d, sinv, 0):
                flag[t] = True
                break
            _solve_rows(d[HALF:, :HALF], d[:HALF, :HALF], sinv[:HALF])
            d[HALF:, HALF:] -= torch.tril(d[HALF:, :HALF] @ d[HALF:, :HALF].mT)
            if not _factor_block(d, sinv, HALF):
                flag[t] = True
                break
            lo[j0:t0, j0:t0] = torch.tril(d[:w, :w])
            lo[t0:, j0:t0] = _solve_rows(lo[t0:, j0:t0].clone(), d[:w, :w], sinv)
            for r0 in range(t0, nb, PANEL):
                for c0 in range(t0, r0 + 1, PANEL):
                    rs, cs = slice(r0, r0 + PANEL), slice(c0, c0 + PANEL)
                    upd = lo[rs, j0:t0] @ lo[cs, j0:t0].mT
                    keep = rows[rs, :1] >= cols[:1, cs]
                    lo[rs, cs] = torch.where(keep, lo[rs, cs] - upd, lo[rs, cs])
    out[flag] = math.nan
    return out


@pytest.mark.parametrize(
    "b,nb",
    [(1, 32), (4, 64), (2, 128), (3, 200), (1, 1)],
)
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_dmma_potrf_step_order_matches_pallas(b, nb, dname):
    """The f64 CUDA instance's arithmetic (panel 64, diagonal factor, panel
    solve, tile-by-tile trailing update) against the Pallas potrf in
    interpret mode, at the shapes and tolerances of
    test_potrf_ref_matches_pallas, plus a ragged nb (200: three full panels
    and one of 8), nb = 1 and a batch of 3."""
    jd, td = DTYPES[dname]
    a = _spd_batch(b, nb)
    got = _emulate_potrf_dmma_f64(torch.as_tensor(a, dtype=td)).numpy()
    want = np.asarray(j_potrf(jnp.asarray(a, jd), interpret=True))
    np.testing.assert_allclose(got, want, **POTRF_TOL[dname])
    assert np.all(np.triu(got, 1) == 0.0)


def test_dmma_potrf_bad_pivot_in_a_later_panel_gives_an_all_nan_tile():
    """A tile that turns indefinite only in its third panel comes back all
    NaN from the emulation (its flag ends the steps), as from potrf_ref;
    the good tiles beside it match the Pallas potrf."""
    nb = 200
    a = _spd_batch(3, nb, seed=1)
    a[1, 150, 150] = -1e4  # a pivot of panel 2 (columns 128..191), second half
    got = _emulate_potrf_dmma_f64(torch.as_tensor(a))
    assert bool(torch.isnan(got[1]).all())
    assert bool(torch.isnan(ref.potrf_ref(torch.as_tensor(a))[1]).all())
    want = np.asarray(j_potrf(jnp.asarray(a[0::2]), interpret=True))
    np.testing.assert_allclose(got[0::2].numpy(), want, **POTRF_TOL["float64"])

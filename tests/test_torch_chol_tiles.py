"""The POTRF and TRSM tile tasks of the port on the CPU.

The plain versions (repro_torch.kernels.ref.potrf_ref / trsm_ref) against
the Pallas kernels run in interpret mode and against the reference's own
plain versions, at the shapes and tolerances of tests/test_kernels.py; the
failure rule (a tile with a bad pivot comes back all NaN and the status is
not ok); the block-column choice of the CUDA trsm's fma_f32 instance and
the plan of its dmma_f64 instance; plain emulations of the dmma_f64
instances' order of work against the Pallas kernels; and that the TLR path
reaches both tasks through kernels.ops.  The CUDA kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chol_tiles import potrf as j_potrf  # noqa: E402
from repro.kernels.chol_tiles import trsm as j_trsm  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.covariance import MaternParams, build_sigma_panel  # noqa: E402
from repro_torch.core.recovery import init_status  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.chol_tiles import (  # noqa: E402
    TRSM_BLOCK,
    TRSM_SUPER,
    trsm_cols,
    trsm_plan,
)

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


def _invert_diag_blocks(lo):
    """The dmma_f64 trsm's first launch: each 64 x 64 diagonal block of lo
    (lo_batch, nb, nb), a ragged last one padded with the identity,
    inverted column by column as its threads do (x <- e_c; per column jj:
    x[jj] *= 1 / L[jj][jj], then x[i] -= L[i][jj] x[jj] below it)."""
    lb, nb, _ = lo.shape
    n = TRSM_BLOCK
    blocks = []
    for j0 in range(0, nb, n):
        w = min(n, nb - j0)
        d = torch.eye(n, dtype=lo.dtype).repeat(lb, 1, 1)
        d[:, :w, :w] = torch.tril(lo[:, j0 : j0 + w, j0 : j0 + w])
        sinv = 1.0 / torch.diagonal(d, dim1=1, dim2=2)
        x = torch.eye(n, dtype=lo.dtype).repeat(lb, 1, 1)
        for jj in range(n):
            x[:, jj] *= sinv[:, jj, None]
            x[:, jj + 1 :] -= d[:, jj + 1 :, jj : jj + 1] * x[:, jj : jj + 1]
        blocks.append(x)
    return torch.stack(blocks, dim=1)


def _emulate_trsm_dmma_f64(lo, b, super_rows=TRSM_SUPER):
    """The dmma_f64 trsm instance's order of work in plain torch, in b's
    dtype: the inverted diagonal blocks D_j; then per super-block of
    ``super_rows`` rows (all of nb <= 512 on the card) the strip launch's
    walk over 64-row block rows, R = B_i - L_i,R0:i X_R0:i and X_i = D_i R
    (the row split's cluster sums the same 64-row products in the same
    order, one block row a block); and between super-blocks the update B_2 -= L_21 X_1 (the large-nb
    schedule)."""
    batch, nb, _ = b.shape
    n = TRSM_BLOCK
    dinv = _invert_diag_blocks(lo)
    if lo.shape[0] == 1:
        lo, dinv = lo.expand(batch, -1, -1), dinv.expand(batch, -1, -1, -1)
    out = b.clone()
    for r0 in range(0, nb, super_rows):
        r1 = min(nb, r0 + super_rows)
        for i0 in range(r0, r1, n):
            i1 = min(nb, i0 + n)
            rest = out[:, i0:i1] - lo[:, i0:i1, r0:i0] @ out[:, r0:i0]
            out[:, i0:i1] = dinv[:, i0 // n, : i1 - i0, : i1 - i0] @ rest
        if r1 < nb:
            out[:, r1:] = out[:, r1:] - lo[:, r1:, r0:r1] @ out[:, r0:r1]
    return out


def _matern_lkk(n_side, a):
    """The factor of a bivariate Matérn covariance tile (nugget 1e-8) on a
    jittered n_side^2 grid: far worse conditioned than a a^T + nb I."""
    locs = torch.as_tensor(grid_locations(n_side, jitter=0.3, seed=0))
    params = MaternParams.bivariate(
        sigma11=1.0, sigma22=1.0, a=a, nu11=0.5, nu22=1.5, beta=0.5, device="cpu"
    )
    sigma = build_sigma_panel(locs, locs, params)
    m = sigma.shape[0]
    return torch.linalg.cholesky(sigma + 1e-8 * torch.eye(m, dtype=sigma.dtype))


@pytest.mark.parametrize(
    "b,nb,m,lo_b,super_rows",
    [
        (1, 32, 32, 1, TRSM_SUPER),
        (3, 64, 16, 3, TRSM_SUPER),
        (2, 64, 128, 2, TRSM_SUPER),
        (3, 200, 37, 3, TRSM_SUPER),  # ragged: three full blocks and one of 8
        (3, 200, 37, 3, 128),  # the large-nb schedule: one update between
        (4, 130, 5, 1, 64),  # L broadcast, three super-blocks
        (2, 1, 3, 2, TRSM_SUPER),
    ],
)
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_dmma_trsm_order_of_work_matches_pallas(b, nb, m, lo_b, super_rows, dname):
    """The f64 CUDA trsm instance's arithmetic (inverted 64 x 64 diagonal
    blocks, block-row products, updates between super-blocks) against the
    Pallas trsm in interpret mode, at the tolerances of
    test_trsm_ref_matches_pallas: its shapes, a ragged nb in both
    schedules, a broadcast factor and nb = 1."""
    jd, td = DTYPES[dname]
    lo = np.linalg.cholesky(_spd_batch(lo_b, nb))
    bb = np.random.default_rng(3).normal(size=(b, nb, m))
    got = _emulate_trsm_dmma_f64(
        torch.as_tensor(lo, dtype=td), torch.as_tensor(bb, dtype=td), super_rows
    )
    lo_full = np.broadcast_to(lo, (b, nb, nb))
    want = j_trsm(jnp.asarray(lo_full, jd), jnp.asarray(bb, jd), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRSM_TOL[dname])


@pytest.mark.parametrize("super_rows", [TRSM_SUPER, 128])
def test_dmma_trsm_on_an_ill_conditioned_matern_factor_matches_pallas(super_rows):
    """The f64 instance's order of work on the factor of a Matérn tile with
    nugget 1e-8 (m = 200, range 1.0: the factor's condition number is
    about 2e3, against about 2 for the factor of a a^T + nb I), at the
    tolerance of test_trsm_ref_matches_pallas: inverting the diagonal
    blocks keeps the digits that substitution keeps."""
    lo = _matern_lkk(10, 1.0)[None]
    assert float(torch.linalg.cond(lo[0])) > 1e3
    bb = np.random.default_rng(4).normal(size=(2, lo.shape[1], 24))
    got = _emulate_trsm_dmma_f64(lo, torch.as_tensor(bb), super_rows)
    lo_full = np.broadcast_to(lo.numpy(), (2, *lo.shape[1:]))
    want = j_trsm(jnp.asarray(lo_full), jnp.asarray(bb), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRSM_TOL["float64"])
    plain = ref.trsm_ref(lo, torch.as_tensor(bb))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TRSM_TOL["float64"])


@pytest.mark.parametrize(
    "batch,nb,r,want",
    [
        (63, 512, 128, (64, 512, 0, 0)),  # panel TRSM: 126 strips
        (32, 512, 128, (32, 512, 0, 0)),  # TLR panel steps 31 to 16
        (9, 512, 128, (16, 512, 0, 0)),
        (5, 512, 128, (8, 512, 0, 0)),
        (1, 512, 128, (8, 512, 0, 0)),  # 16 clusters of 8: too many to split
        (1, 512, 8, (8, 512, 0, 1)),  # 1 cluster of 8 blocks: the rows split
        (1, 512, 1, (8, 512, 0, 1)),  # alpha
        (1, 512, 1024, (8, 512, 0, 0)),  # a request's sweep: 128 strips
        (63, 512, 64, (32, 512, 0, 0)),
        (1, 512, 32256, (64, 512, 0, 0)),  # exact path, panel 512, first step
        (1, 512, 512, (8, 512, 0, 0)),  # and its last
        (1, 4096, 512, (8, 512, 64, 0)),  # nb = 4096: updates of 64 x 64 tiles
        (1, 4096, 1, (8, 512, 64, 1)),
        (1, 4096, 28672, (64, 512, 128, 0)),  # exact path, panel 4096
        (1, 4096, 4096, (32, 512, 128, 0)),  # and its last step
        (3, 200, 37, (8, 256, 0, 1)),
    ],
)
def test_dmma_trsm_plan(batch, nb, r, want):
    """(strip columns, super-block rows, update tile, row split)."""
    assert trsm_plan(batch, nb, r, H100_SMS) == want

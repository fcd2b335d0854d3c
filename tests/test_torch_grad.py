"""The port's gradients against the JAX reference, on the CPU in float64.

The reference differentiates its TLR likelihoods with respect to a traced
nugget (``tests/test_tlr_tiles.py::test_traced_nugget_loglik_and_grad_under_jit``)
through the guarded QR and core SVD of the recompress
(``::test_recompress_grad_matches_finite_differences``).  Here the port's
``tlr_loglik`` and ``dist_tlr_loglik`` (grid and block-cyclic) give the
nugget gradient of central differences and of ``jax.grad`` at the
reference's sizes, the port's recompress the gradient of central
differences with and without zero-padded rank columns, and each kernel's
``torch.autograd.Function`` (``kernels.ops``) passes ``gradcheck`` with the
plain version standing in for the kernel as its forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as jc  # noqa: E402
from repro.core import tlr as jt  # noqa: E402
from repro.core.dist_tlr import dist_tlr_loglik as j_dist_tlr_loglik  # noqa: E402
from repro.core.simulate import simulate_mgrf  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import tlr as tt  # noqa: E402
from repro_torch.core.dist_tlr import dist_tlr_loglik  # noqa: E402
from repro_torch.core.simulate import grid_locations  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PARAMS = dict(a=0.09, nu11=0.5, nu22=1.5, beta=0.5)
# 2 kmax <= nb: the QRs are tall, as in the reference test
KW = dict(tol=1e-7, max_rank=8, tile_size=24)
NUGGET, EPS = 1e-3, 1e-6
FORMS = {
    "tlr": None,
    "dist_grid": False,
    "dist_block_cyclic": True,
}


@pytest.fixture(scope="module")
def case():
    """The reference test's input: 36 Morton-ordered locations of a grid of
    side 6 (m = 72, T = 3), z drawn by the reference, and its jax.grad of
    the loglik in each form at the nugget."""
    locs = grid_locations(6, jitter=0.2, seed=0)
    locs = locs[tc.morton_order(locs)]
    jp = jc.MaternParams.bivariate(**PARAMS)
    z = np.asarray(simulate_mgrf(jax.random.PRNGKey(0), locs, jp, nugget=1e-4)[0])
    lj, zj = jnp.asarray(locs), jnp.asarray(z)

    def loglik(bc):
        def f(ng):
            if bc is None:
                res = jt.tlr_loglik(
                    None, zj, jp, nugget=ng, locs=lj, from_tiles=True, gen="xla", **KW
                )
            else:
                res = j_dist_tlr_loglik(
                    None,
                    zj,
                    locs=lj,
                    params=jp,
                    from_tiles=True,
                    nugget=ng,
                    block_cyclic=bc,
                    gen="xla",
                    **KW,
                )
            return res.loglik

        return f

    grads = {
        name: float(jax.jit(jax.grad(loglik(bc)))(jnp.asarray(NUGGET)))
        for name, bc in FORMS.items()
    }
    tp = tc.MaternParams.bivariate(**PARAMS, device="cpu")
    return dict(locs=locs, z=z, tp=tp, jax_grad=grads)


def _port_loglik(case, form, nugget):
    kw = dict(nugget=nugget, locs=case["locs"], from_tiles=True, gen="plain")
    kw.update(device="cpu", **KW)
    if FORMS[form] is None:
        return tt.tlr_loglik(None, case["z"], case["tp"], **kw).loglik
    return dist_tlr_loglik(
        None, case["z"], params=case["tp"], block_cyclic=FORMS[form], **kw
    ).loglik


@pytest.mark.parametrize("form", list(FORMS))
def test_nugget_grad_matches_finite_differences_and_jax(case, form):
    ng = torch.tensor(NUGGET, dtype=torch.float64, requires_grad=True)
    ll = _port_loglik(case, form, ng)
    (grad,) = torch.autograd.grad(ll, ng)
    with torch.no_grad():
        hi = _port_loglik(case, form, torch.tensor(NUGGET + EPS, dtype=torch.float64))
        lo = _port_loglik(case, form, torch.tensor(NUGGET - EPS, dtype=torch.float64))
    fd = (float(hi) - float(lo)) / (2 * EPS)
    g = float(grad)
    assert np.isfinite(g)
    assert g == pytest.approx(fd, rel=1e-4, abs=1e-6)
    assert g == pytest.approx(case["jax_grad"][form], rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("pads", [False, True])
def test_recompress_grad_matches_finite_differences(pads):
    """The reference test's case: (3, 16, 4) normal factors, with and
    without their columns 2: zeroed (the production case, where the
    unguarded QR and SVD derivatives give NaN)."""
    rng = np.random.default_rng(0)
    arrs = [torch.as_tensor(rng.normal(size=(3, 16, 4))) for _ in range(4)]
    if pads:
        for a in arrs:
            a[:, :, 2:] = 0.0

    def loss(s):
        u1, v1, u2, v2 = arrs
        un, vn, _ = tt._batched_recompress(u1 * s, v1, u2, v2, 1e-7, 1.0)
        return torch.sum(un**2) + torch.sum(vn**2)

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(s), s)
    e = 1e-6
    with torch.no_grad():
        hi, lo = (loss(torch.tensor(x, dtype=torch.float64)) for x in (1 + e, 1 - e))
    fd = (float(hi) - float(lo)) / (2 * e)
    assert np.isfinite(float(g))
    assert float(g) == pytest.approx(fd, rel=1e-5)


@pytest.mark.parametrize("shape", [(2, 9, 4), (2, 3, 5)], ids=["tall", "wide"])
def test_guarded_qr_and_svd_backward_on_full_rank_input(shape):
    """Away from the padding the guards change nothing: both backwards pass
    gradcheck on full-rank input, the QR in its tall and wide forms."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)
    core = torch.as_tensor(rng.normal(size=(2, 4, 4)), dtype=torch.float64)

    def qr(x):
        q, r = tt._SafeQR.apply(x)
        return q, r

    def svd(x):
        # the signs of the singular vectors are fixed by the pairs' products
        u, s, vt = tt._CoreSVD.apply(x)
        return u * vt.mT, s

    assert torch.autograd.gradcheck(qr, (a.requires_grad_(),))
    assert torch.autograd.gradcheck(svd, (core.requires_grad_(),))


def _spd(rng, b, nb):
    a = rng.normal(size=(b, nb, nb))
    return torch.as_tensor(a @ a.transpose(0, 2, 1) + nb * np.eye(nb))


def _sym(x):
    return 0.5 * (x + x.mT)


@pytest.mark.parametrize("kernel", ["potrf", "trsm", "trsm_one_l", "tlr_mm", "syrk"])
def test_kernel_function_backward_passes_gradcheck(kernel):
    """Each kernel's Function, its forward the plain version, in float64 at
    small shapes.  potrf reads the lower triangle of a symmetric tile, so
    its input is symmetrised first (the derivative it returns is
    symmetric); trsm's L is lower triangular, its upper part unread."""
    rng = np.random.default_rng(2)

    def t(*shape):
        x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float64)
        return x.requires_grad_()

    if kernel == "potrf":
        a = _spd(rng, 2, 5).requires_grad_()
        args, fn = (a,), lambda x: ops.PotrfFn.apply(_sym(x), ref.potrf_ref)
    elif kernel.startswith("trsm"):
        lb = 1 if kernel == "trsm_one_l" else 3
        lo = torch.linalg.cholesky(_spd(rng, lb, 4)).requires_grad_()
        args = (lo, t(3, 4, 2))
        fn = lambda x, b: ops.TrsmFn.apply(torch.tril(x), b, ref.trsm_ref)  # noqa: E731
    elif kernel == "tlr_mm":
        args = (t(2, 6, 3), t(2, 6, 3), t(2, 6, 3), t(2, 6, 3), t(2, 6, 6))
        fn = lambda *x: ops.TlrMmFn.apply(*x, ref.tlr_mm_ref)  # noqa: E731
    else:
        args = (t(2, 5, 5), t(2, 5, 3))
        fn = lambda c, a: ops.SyrkFn.apply(c, a, ref.syrk_ref)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args)


def test_out_form_refuses_grad_and_kernels_run_under_grad_on_the_cpu():
    """``tlr_mm(..., out=)`` writes in place, so it refuses factors that
    require grad; the dispatchers give outputs with a grad_fn."""
    rng = np.random.default_rng(3)
    f = [torch.as_tensor(rng.normal(size=(2, 6, 3))).requires_grad_() for _ in range(4)]
    acc = torch.zeros((2, 6, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="out= is not differentiable"):
        ops.tlr_mm(*f, acc, out=acc.clone())
    assert ops.tlr_mm(*f, acc).grad_fn is not None
    a = _spd(rng, 1, 4).requires_grad_()
    lo = ops.potrf(a)
    assert lo.grad_fn is not None
    assert ops.trsm(lo, a).grad_fn is not None
    assert ops.syrk(a, lo).grad_fn is not None
    with torch.no_grad():
        assert ops.potrf(a).grad_fn is None

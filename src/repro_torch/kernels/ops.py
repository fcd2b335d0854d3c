"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro.kernels.ops`` (its ``_mode``).  The tensors' device
decides: a CUDA tensor launches the hand kernel, which raises if it cannot
be built or launched; a CPU tensor takes the plain PyTorch version.  There
is no fallback from one to the other.  Each CUDA wrapper counts its
launches (``launch_counts``), so a run can show that it went through the
kernels; each kernel has two instances and also counts its launches by
instance (``instance_counts``).

``potrf``, ``trsm``, ``tlr_mm`` and ``syrk`` run under autograd on either
device: each is a ``torch.autograd.Function`` whose forward is the kernel
(or, on the CPU, its plain version) and whose backward is plain PyTorch,
since the TPU kernels define none.  The Matérn kernels define no derivative
(the reference's Pallas ``matern_tile`` has none) and refuse, on the card,
inputs that require grad.
"""

from __future__ import annotations

import torch

from . import ref
from .chol_tiles import potrf_cuda, syrk_cuda, trsm_cuda
from .flash_attention import flash_attention_cuda
from .matern_corr import matern_corr_cuda
from .matern_tile import matern_tile_cuda
from .tlr_mm import check_out, tlr_mm_cuda

_WRAPPERS = {
    "matern_tile": matern_tile_cuda,
    "matern_corr": matern_corr_cuda,
    "tlr_mm": tlr_mm_cuda,
    "potrf": potrf_cuda,
    "trsm": trsm_cuda,
    "syrk": syrk_cuda,
    "flash_attention": flash_attention_cuda,
}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def records_grad(*xs) -> bool:
    """Whether autograd records ops on any tensor among ``xs``."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs
    )


def _refuse_grad(name: str, *xs) -> None:
    if records_grad(*xs):
        raise ValueError(
            f"{name}: the CUDA kernel defines no derivative (nor does the "
            "reference's Pallas kernel); pass Matérn parameters and locations "
            "that do not require grad"
        )


def matern_tile(locs_a, locs_b, inv_range, amp, *, nu) -> torch.Tensor:
    """C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range) for any order nu > 0
    (a float or a 0-d tensor)."""
    if _on_cpu(locs_a, "matern_tile"):
        return ref.matern_tile_ref(locs_a, locs_b, inv_range, amp, nu)
    _refuse_grad("matern_tile", locs_a, locs_b, inv_range, amp, nu)
    return matern_tile_cuda(locs_a, locs_b, inv_range, amp, nu=nu)


def matern_correlation(u, nu, *, amp=1.0) -> torch.Tensor:
    """amp * M_nu(u) elementwise over scaled distances u, for any order
    nu > 0 (a float or a 0-d tensor)."""
    if _on_cpu(u, "matern_correlation"):
        return ref.matern_corr_ref(u, amp, nu)
    _refuse_grad("matern_correlation", u, amp, nu)
    return matern_corr_cuda(u.contiguous(), amp, nu=nu)


class PotrfFn(torch.autograd.Function):
    """L = potrf(A) by ``fwd`` (the kernel, or its plain version), with the
    derivative of ``jnp.linalg.cholesky``: A-bar = sym(L^-T Phi(L^T L-bar)
    L^-1), Phi the lower triangle with its diagonal halved and sym(X) =
    (X + X^T) / 2 (a symmetric A-bar: the kernel reads only the lower
    triangle, and the reference symmetrises the tangent)."""

    @staticmethod
    def forward(ctx, a, fwd):
        lo = fwd(a)
        ctx.save_for_backward(lo)
        return lo

    @staticmethod
    def backward(ctx, g):
        (lo,) = ctx.saved_tensors
        phi = torch.tril(lo.mT @ torch.tril(g))
        phi = phi - 0.5 * torch.diag_embed(torch.diagonal(phi, dim1=-2, dim2=-1))
        s = torch.linalg.solve_triangular(lo.mT, phi, upper=True)
        s = torch.linalg.solve_triangular(lo, s, upper=False, left=False)
        return 0.5 * (s + s.mT), None


class TrsmFn(torch.autograd.Function):
    """X = L^{-1} B by ``fwd``: B-bar = L^{-T} X-bar, L-bar = -tril(B-bar
    X^T), summed over the batch where one L serves it."""

    @staticmethod
    def forward(ctx, lo, b, fwd):
        x = fwd(lo, b)
        ctx.save_for_backward(lo, x)
        return x

    @staticmethod
    def backward(ctx, g):
        lo, x = ctx.saved_tensors
        gb = torch.linalg.solve_triangular(lo.mT, g, upper=True)
        gl = None
        if ctx.needs_input_grad[0]:
            gl = -torch.tril(gb @ x.mT)
            if lo.shape[0] == 1 and gl.shape[0] != 1:
                gl = gl.sum(0, keepdim=True)
        return gl, gb, None


class TlrMmFn(torch.autograd.Function):
    """out = acc - U_a W U_b^T, W = V_a^T V_b, by ``fwd``; the backward is
    the products' (the factors' gradients in their dtype, acc's in its)."""

    @staticmethod
    def forward(ctx, u_a, v_a, u_b, v_b, acc, fwd):
        ctx.save_for_backward(u_a, v_a, u_b, v_b)
        return fwd(u_a, v_a, u_b, v_b, acc)

    @staticmethod
    def backward(ctx, g):
        u_a, v_a, u_b, v_b = ctx.saved_tensors
        gf = g.to(u_a.dtype)
        w = v_a.mT @ v_b
        gw = -(u_a.mT @ gf @ u_b)
        return (
            -(gf @ u_b @ w.mT),
            v_b @ gw.mT,
            -(gf.mT @ u_a @ w),
            v_a @ gw,
            g,
            None,
        )


class SyrkFn(torch.autograd.Function):
    """out = C - A A^T by ``fwd``: C-bar = out-bar, A-bar = -(G + G^T) A."""

    @staticmethod
    def forward(ctx, c, a, fwd):
        ctx.save_for_backward(a)
        return fwd(c, a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return g, -((g + g.mT) @ a), None


def tlr_mm(u_a, v_a, u_b, v_b, acc, *, out=None) -> torch.Tensor:
    """acc - U_a (V_a^T V_b) U_b^T for a batch of tile pairs.  With ``out``
    the result is written there and returned; ``out`` may be ``acc``
    itself (the update in place) and may share memory with nothing else.
    float32 factors may update a float64 ``acc``: the product is formed in
    float32 and subtracted in float64 (the mixed SYRK's widening)."""
    cpu = _on_cpu(acc, "tlr_mm")
    if out is None:
        fwd = ref.tlr_mm_ref if cpu else tlr_mm_cuda
        return TlrMmFn.apply(u_a, v_a, u_b, v_b, acc, fwd)
    if records_grad(u_a, v_a, u_b, v_b, acc):
        raise ValueError("tlr_mm: out= is not differentiable; call it without out")
    if cpu:
        res = ref.tlr_mm_ref(u_a, v_a, u_b, v_b, acc)
        factors = (("u_a", u_a), ("v_a", v_a), ("u_b", u_b), ("v_b", v_b))
        check_out(out, acc, factors)
        return out.copy_(res)
    return tlr_mm_cuda(u_a, v_a, u_b, v_b, acc, out=out)


def potrf(a) -> torch.Tensor:
    """Lower Cholesky factors of a (B, nb, nb) batch of SPD tiles; a tile
    with a pivot that is not positive and finite comes back all NaN."""
    if _on_cpu(a, "potrf"):
        return PotrfFn.apply(a, ref.potrf_ref)
    return PotrfFn.apply(a.contiguous(), potrf_cuda)


def trsm(lo, b) -> torch.Tensor:
    """X = L^{-1} B for lower L: lo (B or 1, nb, nb), b (B, nb, r)."""
    if _on_cpu(b, "trsm"):
        return TrsmFn.apply(lo, b, ref.trsm_ref)
    return TrsmFn.apply(lo.contiguous(), b.contiguous(), trsm_cuda)


def syrk(c, a) -> torch.Tensor:
    """C - A A^T for a batch: c (B, nb, nb), a (B, nb, k).  On the card a
    ``c`` whose rows are strided is read in place, not copied."""
    if _on_cpu(c, "syrk"):
        return SyrkFn.apply(c, a, ref.syrk_ref)
    if c.dim() == 3 and c.stride(-1) != 1:
        c = c.contiguous()
    if a.dim() == 3 and a.stride(-1) != 1 and a.stride(-2) != 1:
        a = a.contiguous()
    return SyrkFn.apply(c, a, syrk_cuda)


def attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Causal GQA attention, queries right-aligned to the keys: q (BH, Sq, D),
    k and v (BKV, Skv, D); an optional sliding ``window``."""
    if _on_cpu(q, "attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def instance_counts() -> dict:
    """Launches of each instance of the kernels that have more than one,
    since the last reset."""
    return {
        name: dict(fn.launches_by_instance)
        for name, fn in _WRAPPERS.items()
        if hasattr(fn, "launches_by_instance")
    }


def reset_launch_counts() -> None:
    """Set every count to 0, the counts by instance too."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
        for instance in getattr(fn, "launches_by_instance", {}):
            fn.launches_by_instance[instance] = 0

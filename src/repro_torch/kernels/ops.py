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

**Operators.**  Each CUDA wrapper is a ``torch.library.custom_op``
(``repro_torch::potrf`` and so on) whose CUDA implementation is the wrapper
itself, unchanged: a real CUDA tensor launches the kernel and counts the
launch, as before.  While a dispatch mode traces, a call goes through the
op; otherwise straight to that implementation, without the dispatcher's
cost a call (``_kernel``).  Each op also has a fake
implementation (the output's shape, dtype and device, no launch), so a
shape-only trace under ``FakeTensorMode`` passes through the same op the
card runs (the dry-run, ``launch.dryrun``), and a FLOP formula
(``torch.utils.flop_counter``), the counts behind PERF.md's bounds, so
``FlopCounterMode`` counts a kernel's work on the card and in a fake trace
alike.  A CPU tensor never reaches an op: it takes the plain version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

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


# ---------------------------------------------------------------------------
# The kernels as operators
# ---------------------------------------------------------------------------

# Arithmetic operations of the Matérn kernels an element (exp, log, sqrt,
# sinh, cosh and a division counted as one each): the distance of two
# locations (matern_tile only), the halfint closed form by order, and the
# general instance's fixed part and series set-up, the least it does (its
# steps depend on the data: PERF.md counts them on the card).
MATERN_DIST_OPS = 6
MATERN_HALFINT_OPS = {0.5: 4, 1.5: 6, 2.5: 9}
MATERN_GENERAL_OPS = 9 + 21


def _matern_ops(nu: float) -> int:
    return MATERN_HALFINT_OPS.get(float(nu), MATERN_GENERAL_OPS)


def _matern_tile_impl(
    locs_a: torch.Tensor, locs_b: torch.Tensor, inv_range: float, amp: float, nu: float
) -> torch.Tensor:
    return matern_tile_cuda(locs_a, locs_b, inv_range, amp, nu=nu)


_matern_tile_op = custom_op(
    "repro_torch::matern_tile", _matern_tile_impl, mutates_args=(), device_types="cuda"
)


@_matern_tile_op.register_fake
def _(locs_a, locs_b, inv_range, amp, nu):
    return locs_a.new_empty((locs_a.shape[0], locs_b.shape[0]))


@register_flop_formula(torch.ops.repro_torch.matern_tile)
def _(a_shape, b_shape, inv_range, amp, nu, *args, **kwargs) -> int:
    return a_shape[0] * b_shape[0] * (MATERN_DIST_OPS + _matern_ops(nu))


def _matern_corr_impl(u: torch.Tensor, amp: float, nu: float) -> torch.Tensor:
    return matern_corr_cuda(u, amp, nu=nu)


_matern_corr_op = custom_op(
    "repro_torch::matern_corr", _matern_corr_impl, mutates_args=(), device_types="cuda"
)


@_matern_corr_op.register_fake
def _(u, amp, nu):
    return torch.empty_like(u, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.matern_corr)
def _(u_shape, amp, nu, *args, **kwargs) -> int:
    return int(np.prod(u_shape)) * _matern_ops(nu)


def _tlr_mm_flops(a_shape) -> int:
    # W = V_a^T V_b, T = U_a W, out = acc - T U_b^T
    b, nb, k = a_shape
    return 2 * b * (2 * nb * k * k + nb * nb * k)


def _tlr_mm_impl(
    u_a: torch.Tensor,
    v_a: torch.Tensor,
    u_b: torch.Tensor,
    v_b: torch.Tensor,
    acc: torch.Tensor,
) -> torch.Tensor:
    return tlr_mm_cuda(u_a, v_a, u_b, v_b, acc)


_tlr_mm_op = custom_op(
    "repro_torch::tlr_mm", _tlr_mm_impl, mutates_args=(), device_types="cuda"
)


@_tlr_mm_op.register_fake
def _(u_a, v_a, u_b, v_b, acc):
    return torch.empty_like(acc, memory_format=torch.contiguous_format)


def _tlr_mm_out_impl(
    u_a: torch.Tensor,
    v_a: torch.Tensor,
    u_b: torch.Tensor,
    v_b: torch.Tensor,
    acc: torch.Tensor,
    out: torch.Tensor,
) -> None:
    tlr_mm_cuda(u_a, v_a, u_b, v_b, acc, out=out)


_tlr_mm_out_op = custom_op(
    "repro_torch::tlr_mm_out", _tlr_mm_out_impl, mutates_args=("out",),
    device_types="cuda",
)


@_tlr_mm_out_op.register_fake
def _(u_a, v_a, u_b, v_b, acc, out):
    return None


@register_flop_formula(
    [torch.ops.repro_torch.tlr_mm, torch.ops.repro_torch.tlr_mm_out]
)
def _(a_shape, *args, **kwargs) -> int:
    return _tlr_mm_flops(a_shape)


@custom_op("repro_torch::potrf", mutates_args=(), device_types="cuda")
def _potrf_op(a: torch.Tensor) -> torch.Tensor:
    return potrf_cuda(a)


@_potrf_op.register_fake
def _(a):
    return torch.empty_like(a, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.potrf)
def _(a_shape, *args, **kwargs) -> int:
    b, nb, _ = a_shape
    return b * nb**3 // 3


@custom_op("repro_torch::trsm", mutates_args=(), device_types="cuda")
def _trsm_op(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return trsm_cuda(lo, b)


@_trsm_op.register_fake
def _(lo, b):
    return torch.empty_like(b, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.trsm)
def _(lo_shape, b_shape, *args, **kwargs) -> int:
    batch, nb, r = b_shape
    return batch * nb * nb * r  # a triangle: nb^2 / 2 FMAs a column


@custom_op("repro_torch::syrk", mutates_args=(), device_types="cuda")
def _syrk_op(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return syrk_cuda(c, a)


@_syrk_op.register_fake
def _(c, a):
    return c.new_empty(c.shape)


@register_flop_formula(torch.ops.repro_torch.syrk)
def _(c_shape, a_shape, *args, **kwargs) -> int:
    b, nb, k = a_shape
    return b * nb * (nb + 1) * k  # the lower triangle's FMAs


def attention_pairs(sq: int, skv: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention with queries
    right-aligned to the keys and an optional window."""
    qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros_like(qpos)
    return int((qpos - lo + 1).sum())


def _flash_impl(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    window: int,
    scale: float | None,
) -> torch.Tensor:
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


_flash_op = custom_op(
    "repro_torch::flash_attention", _flash_impl, mutates_args=(), device_types="cuda"
)


@_flash_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    bh, sq, d = q_shape
    skv = k_shape[1]
    pairs = attention_pairs(sq, skv, window) if causal else sq * skv
    return 4 * d * pairs * bh  # Q K^T and P V


def _kernel(op, impl, *xs):
    """``op`` (the operator) while a dispatch mode traces (``FakeTensorMode``,
    ``FlopCounterMode``, the dry-run's counters) or an argument is a tensor
    subclass (a fake tensor): the trace then sees the kernel.  Else
    ``impl``, the operator's CUDA implementation, called without the
    dispatcher, which costs tens of microseconds a call (PERF.md)."""
    if torch._C._len_torch_dispatch_stack() or any(
        type(x) is not torch.Tensor for x in xs
    ):
        return op
    return impl


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
    run = _kernel(_matern_tile_op, _matern_tile_impl, locs_a, locs_b)
    return run(locs_a, locs_b, float(inv_range), float(amp), float(nu))


def matern_correlation(u, nu, *, amp=1.0) -> torch.Tensor:
    """amp * M_nu(u) elementwise over scaled distances u, for any order
    nu > 0 (a float or a 0-d tensor)."""
    if _on_cpu(u, "matern_correlation"):
        return ref.matern_corr_ref(u, amp, nu)
    _refuse_grad("matern_correlation", u, amp, nu)
    run = _kernel(_matern_corr_op, _matern_corr_impl, u)
    return run(u.contiguous(), float(amp), float(nu))


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
        fwd = ref.tlr_mm_ref if cpu else _kernel(_tlr_mm_op, _tlr_mm_impl, acc, u_a)
        return TlrMmFn.apply(u_a, v_a, u_b, v_b, acc, fwd)
    if records_grad(u_a, v_a, u_b, v_b, acc):
        raise ValueError("tlr_mm: out= is not differentiable; call it without out")
    if cpu:
        res = ref.tlr_mm_ref(u_a, v_a, u_b, v_b, acc)
        factors = (("u_a", u_a), ("v_a", v_a), ("u_b", u_b), ("v_b", v_b))
        check_out(out, acc, factors)
        return out.copy_(res)
    run = _kernel(_tlr_mm_out_op, _tlr_mm_out_impl, out, acc, u_a)
    run(u_a, v_a, u_b, v_b, acc, out)
    return out


def potrf(a) -> torch.Tensor:
    """Lower Cholesky factors of a (B, nb, nb) batch of SPD tiles; a tile
    with a pivot that is not positive and finite comes back all NaN."""
    if _on_cpu(a, "potrf"):
        return PotrfFn.apply(a, ref.potrf_ref)
    return PotrfFn.apply(a.contiguous(), _kernel(_potrf_op, potrf_cuda, a))


def trsm(lo, b) -> torch.Tensor:
    """X = L^{-1} B for lower L: lo (B or 1, nb, nb), b (B, nb, r)."""
    if _on_cpu(b, "trsm"):
        return TrsmFn.apply(lo, b, ref.trsm_ref)
    fwd = _kernel(_trsm_op, trsm_cuda, lo, b)
    return TrsmFn.apply(lo.contiguous(), b.contiguous(), fwd)


def syrk(c, a) -> torch.Tensor:
    """C - A A^T for a batch: c (B, nb, nb), a (B, nb, k).  On the card a
    ``c`` whose rows are strided is read in place, not copied."""
    if _on_cpu(c, "syrk"):
        return SyrkFn.apply(c, a, ref.syrk_ref)
    if c.dim() == 3 and c.stride(-1) != 1:
        c = c.contiguous()
    if a.dim() == 3 and a.stride(-1) != 1 and a.stride(-2) != 1:
        a = a.contiguous()
    return SyrkFn.apply(c, a, _kernel(_syrk_op, syrk_cuda, c, a))


def attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Causal GQA attention, queries right-aligned to the keys: q (BH, Sq, D),
    k and v (BKV, Skv, D); an optional sliding ``window``."""
    if _on_cpu(q, "attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    scale = None if scale is None else float(scale)
    run = _kernel(_flash_op, _flash_impl, q, k, v)
    return run(q, k, v, bool(causal), int(window), scale)


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

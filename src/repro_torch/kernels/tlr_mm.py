"""Wrapper of the hand-written CUDA kernel ``csrc/tlr_mm.cu``.

Counterpart of the Pallas kernel ``repro.kernels.tlr_mm.tlr_mm``:
acc - U_a (V_a^T V_b) U_b^T, batched over tile pairs.  The plain version is
``kernels.ref.tlr_mm_ref``; ``kernels.ops`` chooses between the two by the
tensors' device.  The dtypes pick one of the kernel's two instances:
float64 runs ``dmma_f64`` (the three products on the FP64 tensor cores),
float32 factors ``fma_f32`` (the FP32 CUDA cores), with a float32 ``acc``
or, for the SYRK of a mixed precision policy, a float64 one: the f32
product is then widened exactly and subtracted in f64 (``out = acc -
(double) y``, y rounded as the all-f32 form rounds it).  The result may be
written into ``acc`` itself (``out=acc``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# (factor dtype, acc dtype) -> (instance, its C symbol)
_INSTANCES = {
    (torch.float64, torch.float64): ("dmma_f64", "tlr_mm_f64"),
    (torch.float32, torch.float32): ("fma_f32", "tlr_mm_f32"),
    (torch.float32, torch.float64): ("fma_f32", "tlr_mm_f32_wide"),
}


def instance(dtype: torch.dtype, acc_dtype: torch.dtype | None = None) -> str:
    """Name of the kernel instance that takes factors of ``dtype`` and an
    ``acc`` of ``acc_dtype`` (by default ``dtype``); raises on any other
    pair: all float64, all float32, or float32 factors with a float64
    ``acc``."""
    key = (dtype, dtype if acc_dtype is None else acc_dtype)
    if key not in _INSTANCES:
        raise ValueError(
            "tlr_mm takes float32 or float64 factors with an acc of their dtype, "
            f"or float32 factors with a float64 acc; got {key[0]} and {key[1]}"
        )
    return _INSTANCES[key][0]


def _fn(key):
    fn = getattr(_build.library(), _INSTANCES[key][1])
    p, i = ctypes.c_void_p, ctypes.c_int
    # f64: the factors, acc, W scratch, out; f32: a second scratch for T
    pointers = 7 if key[0] == torch.float64 else 8
    fn.argtypes = [p] * pointers + [i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def check_out(out: torch.Tensor, acc: torch.Tensor, inputs) -> None:
    """Refuse an ``out`` that cannot take the result: another shape or
    dtype than ``acc``, or memory shared with any argument other than
    ``acc`` itself (the same storage, whole).  Fake tensors (a shape-only
    trace) have no memory to compare."""
    from torch._subclasses.fake_tensor import is_fake

    if out.shape != acc.shape or out.dtype != acc.dtype or out.device != acc.device:
        raise ValueError(
            f"out must match acc: {tuple(acc.shape)} {acc.dtype} on {acc.device}, "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}"
        )
    if is_fake(out):
        return
    lo, hi = _span(out)
    for name, t in (*inputs, ("acc", acc)):
        t_lo, t_hi = _span(t)
        if t_lo < hi and lo < t_hi:
            same = (
                name == "acc"
                and t_lo == lo
                and t_hi == hi
                and out.stride() == acc.stride()
            )
            if not same:
                raise ValueError(f"out overlaps {name}; only out=acc may share memory")


def tlr_mm_cuda(u_a, v_a, u_b, v_b, acc, out=None) -> torch.Tensor:
    """Launch the CUDA kernel.

    u_a, v_a, u_b, v_b: (B, nb, k) of one dtype; acc: (B, nb, nb) of that
    dtype, or float64 beside float32 factors; all contiguous CUDA tensors
    on one device.  Writes the result into ``out`` when one is given (a
    contiguous (B, nb, nb) tensor of acc's dtype, which may be ``acc``
    itself and overlap nothing else), else into a new tensor, and returns
    it.  Raises on anything the kernel does not take, before the library is
    built, and if a launch fails.
    """
    args = {"u_a": u_a, "v_a": v_a, "u_b": u_b, "v_b": v_b, "acc": acc}
    dtype, acc_dtype, device = u_a.dtype, acc.dtype, u_a.device
    inst = instance(dtype, acc_dtype)
    if u_a.dim() != 3:
        raise ValueError(f"u_a must have shape (B, nb, k), got {tuple(u_a.shape)}")
    b, nb, k = u_a.shape
    if out is not None:
        args["out"] = out
    for name, t in args.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        want_dtype = acc_dtype if name in ("acc", "out") else dtype
        if t.dtype != want_dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (b, nb, nb) if name in ("acc", "out") else (b, nb, k)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    if k < 1 or nb < 1:
        raise ValueError(f"tlr_mm needs nb >= 1 and k >= 1, got nb={nb}, k={k}")
    if b > 65535 or b * nb * nb >= 2**62:
        raise ValueError(f"batch {b} of {nb}x{nb} tiles is too large")
    if out is None:
        out = torch.empty_like(acc)
    else:
        factors = [(n, args[n]) for n in ("u_a", "v_a", "u_b", "v_b")]
        check_out(out, acc, factors)
    if b == 0:
        return out
    # W = V_a^T V_b (B, k, k); the f32 instance also keeps T = U_a W
    scratch = [torch.empty((b, k, k), dtype=dtype, device=device)]
    if dtype == torch.float32:
        scratch.append(torch.empty((b, nb, k), dtype=dtype, device=device))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (u_a, v_a, u_b, v_b, acc, *scratch, out)]
        rc = _fn((dtype, acc_dtype))(*ptrs, b, nb, k, stream)
    _build.check(rc, f"tlr_mm ({inst})")
    tlr_mm_cuda.launches += 1
    tlr_mm_cuda.launches_by_instance[inst] += 1
    return out


tlr_mm_cuda.launches = 0
tlr_mm_cuda.launches_by_instance = {name: 0 for name, _ in _INSTANCES.values()}

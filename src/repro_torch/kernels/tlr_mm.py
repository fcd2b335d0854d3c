"""Wrapper of the hand-written CUDA kernel ``csrc/tlr_mm.cu``.

Counterpart of the Pallas kernel ``repro.kernels.tlr_mm.tlr_mm``:
acc - U_a (V_a^T V_b) U_b^T, batched over tile pairs.  The plain version is
``kernels.ref.tlr_mm_ref``; ``kernels.ops`` chooses between the two by the
tensors' device.  The dtype picks one of the kernel's two instances:
float64 runs ``dmma_f64`` (the three products on the FP64 tensor cores),
float32 ``fma_f32`` (the FP32 CUDA cores).  The result may be written into
``acc`` itself (``out=acc``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# dtype -> (instance, its C symbol)
_INSTANCES = {
    torch.float64: ("dmma_f64", "tlr_mm_f64"),
    torch.float32: ("fma_f32", "tlr_mm_f32"),
}


def instance(dtype: torch.dtype) -> str:
    """Name of the kernel instance that takes ``dtype``; raises on any other."""
    if dtype not in _INSTANCES:
        raise ValueError(f"tlr_mm takes float32 or float64, got {dtype}")
    return _INSTANCES[dtype][0]


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _INSTANCES[dtype][1])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def check_out(out: torch.Tensor, acc: torch.Tensor, inputs) -> None:
    """Refuse an ``out`` that cannot take the result: another shape or
    dtype than ``acc``, or memory shared with any argument other than
    ``acc`` itself (the same storage, whole)."""
    if out.shape != acc.shape or out.dtype != acc.dtype or out.device != acc.device:
        raise ValueError(
            f"out must match acc: {tuple(acc.shape)} {acc.dtype} on {acc.device}, "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}"
        )
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

    u_a, v_a, u_b, v_b: (B, nb, k); acc: (B, nb, nb); all contiguous CUDA
    tensors of one dtype (float32 or float64) on one device.  Writes the
    result into ``out`` when one is given (a contiguous (B, nb, nb) tensor,
    which may be ``acc`` itself and overlap nothing else), else into a new
    tensor, and returns it.  Raises on anything the kernel does not take and
    if a launch fails.
    """
    args = {"u_a": u_a, "v_a": v_a, "u_b": u_b, "v_b": v_b, "acc": acc}
    dtype, device = u_a.dtype, u_a.device
    inst = instance(dtype)
    if u_a.dim() != 3:
        raise ValueError(f"u_a must have shape (B, nb, k), got {tuple(u_a.shape)}")
    b, nb, k = u_a.shape
    if out is not None:
        args["out"] = out
    for name, t in args.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
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
    scratch = torch.empty((b, k, k), dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (u_a, v_a, u_b, v_b, acc, scratch, out)]
        rc = _fn(dtype)(*ptrs, b, nb, k, stream)
    _build.check(rc, f"tlr_mm ({inst})")
    tlr_mm_cuda.launches += 1
    tlr_mm_cuda.launches_by_instance[inst] += 1
    return out


tlr_mm_cuda.launches = 0
tlr_mm_cuda.launches_by_instance = {name: 0 for name, _ in _INSTANCES.values()}

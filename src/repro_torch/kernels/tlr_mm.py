"""Wrapper of the hand-written CUDA kernel ``csrc/tlr_mm.cu``.

Counterpart of the Pallas kernel ``repro.kernels.tlr_mm.tlr_mm``:
acc - U_a (V_a^T V_b) U_b^T, batched over tile pairs.  The plain version is
``kernels.ref.tlr_mm_ref``; ``kernels.ops`` chooses between the two by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SYMBOLS = {torch.float64: "tlr_mm_f64", torch.float32: "tlr_mm_f32"}


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _SYMBOLS[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def tlr_mm_cuda(u_a, v_a, u_b, v_b, acc) -> torch.Tensor:
    """Launch the CUDA kernel.

    u_a, v_a, u_b, v_b: (B, nb, k); acc: (B, nb, nb); all contiguous CUDA
    tensors of one dtype (float32 or float64) on one device.  Returns a new
    (B, nb, nb) tensor; ``acc`` is not modified.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    args = {"u_a": u_a, "v_a": v_a, "u_b": u_b, "v_b": v_b, "acc": acc}
    dtype, device = u_a.dtype, u_a.device
    if dtype not in _SYMBOLS:
        raise ValueError(f"tlr_mm takes float32 or float64, got {dtype}")
    if u_a.dim() != 3:
        raise ValueError(f"u_a must have shape (B, nb, k), got {tuple(u_a.shape)}")
    b, nb, k = u_a.shape
    for name, t in args.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (b, nb, nb) if name == "acc" else (b, nb, k)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    if k < 1 or nb < 1:
        raise ValueError(f"tlr_mm needs nb >= 1 and k >= 1, got nb={nb}, k={k}")
    if b > 65535 or b * nb * nb >= 2**62:
        raise ValueError(f"batch {b} of {nb}x{nb} tiles is too large")
    out = torch.empty_like(acc)
    if b == 0:
        return out
    scratch = torch.empty((b, k, k), dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (u_a, v_a, u_b, v_b, acc, scratch, out)]
        rc = _fn(dtype)(*ptrs, b, nb, k, stream)
    _build.check(rc, "tlr_mm")
    tlr_mm_cuda.launches += 1
    return out


tlr_mm_cuda.launches = 0

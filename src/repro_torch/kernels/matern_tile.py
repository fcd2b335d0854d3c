"""Wrapper of the hand-written CUDA kernel ``csrc/matern_tile.cu``.

Counterpart of the Pallas kernel ``repro.kernels.matern_tile.matern_tile``:
C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range) for nu in {0.5, 1.5, 2.5}.
The plain version is ``kernels.ref.matern_tile_ref``; ``kernels.ops``
chooses between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SUPPORTED_NU = (0.5, 1.5, 2.5)
_SYMBOLS = {torch.float64: "matern_tile_f64", torch.float32: "matern_tile_f32"}
_SCALAR = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _SYMBOLS[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, _SCALAR[dtype], _SCALAR[dtype], i, p]
    fn.restype = ctypes.c_int
    return fn


def matern_tile_cuda(
    locs_a: torch.Tensor, locs_b: torch.Tensor, inv_range, amp, *, nu: float
) -> torch.Tensor:
    """Launch the CUDA kernel on (n, 2) and (m, 2) location panels.

    Both panels are contiguous CUDA tensors of one dtype (float32 or
    float64) on one device.  Returns a new (n, m) tensor.  Raises on
    anything the kernel does not take and if the launch fails.
    """
    if nu not in SUPPORTED_NU:
        raise ValueError(f"matern_tile supports nu in {SUPPORTED_NU}, got {nu}")
    for name, t in (("locs_a", locs_a), ("locs_b", locs_b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"{name} must have shape (n, 2), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if locs_a.device != locs_b.device:
        raise ValueError("locs_a and locs_b lie on different devices")
    dtype = locs_a.dtype
    if dtype not in _SYMBOLS or locs_b.dtype != dtype:
        raise ValueError(
            f"matern_tile takes float32 or float64 panels of one dtype, "
            f"got {locs_a.dtype} and {locs_b.dtype}"
        )
    n, m = locs_a.shape[0], locs_b.shape[0]
    if max(n, m) >= 2**31 or n * m >= 2**62:
        raise ValueError(f"panel sizes ({n}, {m}) are too large")
    out = torch.empty((n, m), dtype=dtype, device=locs_a.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(locs_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (locs_a.data_ptr(), locs_b.data_ptr(), out.data_ptr())
        scalars = (float(inv_range), float(amp), int(round(2 * nu)))
        rc = _fn(dtype)(*ptrs, n, m, *scalars, stream)
    _build.check(rc, "matern_tile")
    matern_tile_cuda.launches += 1
    return out


matern_tile_cuda.launches = 0

"""Wrapper of the hand-written CUDA kernel ``csrc/matern_corr.cu``.

out = amp * M_nu(u), elementwise over a tensor of scaled distances u, for
any real nu > 0.  It has no Pallas counterpart: its JAX counterpart is
``repro.core.matern.matern_correlation``, and its plain version
``kernels.ref.matern_corr_ref``; ``kernels.ops.matern_correlation`` chooses
between the two by the tensor's device.  The order picks the instance as for
``matern_tile`` (``halfint`` or ``general``), whose host arrays it shares.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .matern_tile import INSTANCES, launch_args

_SYMBOLS = {torch.float64: "matern_corr_f64", torch.float32: "matern_corr_f32"}
_SCALAR = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _SYMBOLS[dtype])
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_size_t, _SCALAR[dtype], ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def matern_corr_cuda(u: torch.Tensor, amp=1.0, *, nu) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous float32 or float64 CUDA tensor
    of any shape; ``nu`` is any finite order > 0 (a float or a 0-d tensor).
    Returns a new tensor of u's shape and dtype.  Raises on anything the
    kernel does not take and if the launch fails."""
    name, nu2, args = launch_args(nu)
    if u.device.type != "cuda":
        raise ValueError(f"u must be a CUDA tensor, got {u.device}")
    if u.dtype not in _SYMBOLS:
        raise ValueError(f"matern_corr takes float32 or float64, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    out = torch.empty_like(u, memory_format=torch.contiguous_format)
    if u.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(u.dtype)(
            u.data_ptr(), out.data_ptr(), u.numel(), float(amp), nu2, args, stream
        )
    _build.check(rc, "matern_corr")
    matern_corr_cuda.launches += 1
    matern_corr_cuda.launches_by_instance[name] += 1
    return out


matern_corr_cuda.launches = 0
matern_corr_cuda.launches_by_instance = dict.fromkeys(INSTANCES, 0)

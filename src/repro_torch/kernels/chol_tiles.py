"""Wrappers of the hand-written CUDA kernels ``csrc/potrf.cu`` and
``csrc/trsm.cu``: the POTRF and TRSM tile tasks of the blocked Cholesky.

Counterparts of the Pallas kernels ``repro.kernels.chol_tiles.potrf`` and
``.trsm``.  The plain versions are ``kernels.ref.potrf_ref`` and
``trsm_ref``; ``kernels.ops`` chooses by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_POTRF = {torch.float64: "potrf_f64", torch.float32: "potrf_f32"}
_TRSM = {torch.float64: "trsm_f64", torch.float32: "trsm_f32"}
# Dynamic shared memory a trsm block may take for its right-hand-side
# columns (the card allows 227 KB a block; the kernel's static part is 8 KB).
TRSM_SMEM_BYTES = 200 * 1024
TRSM_MAX_COLS = 32
_SM_COUNT = 132  # streaming multiprocessors of an H100 SXM


def _potrf_fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _POTRF[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _trsm_fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _TRSM[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype, device, table) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype not in table or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} must be float32 or float64 of one dtype")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def potrf_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (B, nb, nb) batch of SPD tiles.

    ``a`` is a contiguous float32 or float64 CUDA tensor; only its lower
    triangle is read.  Returns a new tensor holding the lower factors,
    zeros above the diagonal; a tile whose factorization meets a pivot that
    is not positive and finite comes back all NaN.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    _check_cuda("a", a, None, None, _POTRF)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must have shape (B, nb, nb), got {tuple(a.shape)}")
    b, nb, _ = a.shape
    if nb * nb >= 2**31:
        raise ValueError(f"tile size {nb} is too large")
    out = torch.empty_like(a)
    if b == 0 or nb == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _potrf_fn(a.dtype)(a.data_ptr(), out.data_ptr(), b, nb, stream)
    _build.check(code, "potrf")
    potrf_cuda.launches += 1
    return out


potrf_cuda.launches = 0


def trsm_cols(nb: int, r: int, batch: int, itemsize: int) -> int:
    """Right-hand-side columns one trsm block solves: at most 32, a power of
    two, no more than ``r`` needs, halved while the nb x rc block does not fit
    in shared memory or (down to 8) while the grid leaves SMs idle."""
    rc = TRSM_MAX_COLS
    while rc > 1 and rc // 2 >= r:
        rc //= 2
    while rc > 1 and nb * rc * itemsize > TRSM_SMEM_BYTES:
        rc //= 2
    while rc > 8 and -(-r // rc) * batch < _SM_COUNT:
        rc //= 2
    if nb * rc * itemsize > TRSM_SMEM_BYTES:
        raise ValueError(
            f"trsm: a column of {nb} rows does not fit in shared memory"
        )
    return rc


def trsm_cuda(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: X = L^{-1} B for lower L.

    ``lo`` is (B, nb, nb), or (1, nb, nb) to use one factor for the whole
    batch; ``b`` is (B, nb, r).  Both are contiguous CUDA tensors of one
    dtype (float32 or float64) on one device; only the lower triangle of
    ``lo`` is read.  Returns a new (B, nb, r) tensor.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    _check_cuda("b", b, None, None, _TRSM)
    _check_cuda("lo", lo, b.dtype, b.device, _TRSM)
    if b.dim() != 3:
        raise ValueError(f"b must have shape (B, nb, r), got {tuple(b.shape)}")
    batch, nb, r = b.shape
    if lo.dim() != 3 or lo.shape[1:] != (nb, nb) or lo.shape[0] not in (1, batch):
        raise ValueError(
            f"lo has shape {tuple(lo.shape)}, expected (1 or {batch}, {nb}, {nb})"
        )
    if batch > 65535 or nb * nb >= 2**31 or nb * r >= 2**31:
        raise ValueError(f"trsm of shape {tuple(b.shape)} is too large")
    out = torch.empty_like(b)
    if batch == 0 or nb == 0 or r == 0:
        return out
    rc = trsm_cols(nb, r, batch, b.element_size())
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (lo.data_ptr(), b.data_ptr(), out.data_ptr())
        code = _trsm_fn(b.dtype)(*ptrs, batch, nb, r, rc, lo.shape[0], stream)
    _build.check(code, "trsm")
    trsm_cuda.launches += 1
    return out


trsm_cuda.launches = 0

"""Wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``.

Counterpart of the Pallas kernel ``repro.kernels.flash_attention``: causal
GQA attention with an online softmax, an optional sliding window and
queries right-aligned to the keys.  The plain version is
``kernels.ref.attention_ref``; ``kernels.ops`` chooses between the two by
the tensors' device.  The dtype picks one of the kernel's two instances:
bfloat16 runs ``wgmma_bf16`` (Hopper's tensor cores, TMA, warp
specialisation), float32 ``tf32x3_f32`` (the same machinery on the TF32
tensor cores, each f32 product formed from three tf32 passes: the 3xTF32
split, accurate to about 2^-20 of each product).  The bf16 instance takes
head dims 32, 64, 96, 128 and 256 (RecurrentGemma's local attention), the
f32 instance those up to 128: its D = 256 form lies on no path and is not
ported (ROADMAP Queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# dtype -> (instance, its C symbol)
_INSTANCES = {
    torch.bfloat16: ("wgmma_bf16", "flash_attention_bf16"),
    torch.float32: ("tf32x3_f32", "flash_attention_f32"),
}
# instance -> the head dims of its template instances
HEAD_DIMS = {"wgmma_bf16": (32, 64, 96, 128, 256), "tf32x3_f32": (32, 64, 96, 128)}


def instance(dtype: torch.dtype) -> str:
    """Name of the kernel instance that takes ``dtype``; raises on any other."""
    if dtype not in _INSTANCES:
        raise ValueError(f"flash_attention takes bfloat16 or float32, got {dtype}")
    return _INSTANCES[dtype][0]


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _INSTANCES[dtype][1])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q, k, v, *, causal: bool = True, window: int = 0, scale: float | None = None
) -> torch.Tensor:
    """Launch the CUDA kernel.

    q: (BH, Sq, D); k, v: (BKV, Skv, D) with BH = BKV * group and Sq <= Skv;
    all contiguous CUDA tensors of one dtype (bfloat16 or float32) on one
    device, D in the instance's ``HEAD_DIMS``, 16-byte aligned (TMA reads them).
    ``scale`` defaults to 1 / sqrt(D); a
    ``window`` > 0 keeps only the last ``window`` keys of each query.
    Returns a new (BH, Sq, D) tensor in q's dtype.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    dtype, device = q.dtype, q.device
    name_of = instance(dtype)
    d = q.shape[-1]
    if d not in HEAD_DIMS[name_of]:
        raise ValueError(
            f"flash_attention's {name_of} instance takes head dims "
            f"{HEAD_DIMS[name_of]}, got D = {d}"
            + (" (not ported: ROADMAP Queue 2)" if d == 256 else "")
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype:
            raise ValueError("q, k and v must be bfloat16 or float32 of one dtype")
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, expected {device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must have 3 dimensions, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[2] != d:
        raise ValueError(
            f"k and v must have shape (BKV, Skv, {d}), got {tuple(k.shape)} "
            f"and {tuple(v.shape)}"
        )
    if bkv < 1 or bh % bkv:
        raise ValueError(f"query heads {bh} must be a multiple of KV heads {bkv}")
    if sq > skv:
        raise ValueError(f"flash_attention needs Sq <= Skv, got {sq} > {skv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if bh > 65535 or bh * skv * d >= 2**62:
        raise ValueError(f"{bh} query heads of length {skv} are too many")
    if scale is None:
        scale = 1.0 / d**0.5
    out = torch.empty_like(q)
    if sq == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, out)]
        rc = _fn(dtype)(
            *ptrs, bh, sq, skv, d, bh // bkv, scale, int(causal), window, stream
        )
    _build.check(rc, f"flash_attention ({name_of})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_instance[name_of] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_instance = {name: 0 for name, _ in _INSTANCES.values()}

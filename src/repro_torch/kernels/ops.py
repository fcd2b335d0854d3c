"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro.kernels.ops`` (its ``_mode``).  The tensors' device
decides: a CUDA tensor launches the hand kernel, which raises if it cannot
be built or launched; a CPU tensor takes the plain PyTorch version.  There
is no fallback from one to the other.  Each CUDA wrapper counts its
launches (``launch_counts``), so a run can show that it went through the
kernels; each kernel has two instances and also counts its launches by
instance (``instance_counts``).
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


def matern_tile(locs_a, locs_b, inv_range, amp, *, nu) -> torch.Tensor:
    """C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range) for any order nu > 0
    (a float or a 0-d tensor)."""
    if _on_cpu(locs_a, "matern_tile"):
        return ref.matern_tile_ref(locs_a, locs_b, inv_range, amp, nu)
    return matern_tile_cuda(locs_a, locs_b, inv_range, amp, nu=nu)


def matern_correlation(u, nu, *, amp=1.0) -> torch.Tensor:
    """amp * M_nu(u) elementwise over scaled distances u, for any order
    nu > 0 (a float or a 0-d tensor)."""
    if _on_cpu(u, "matern_correlation"):
        return ref.matern_corr_ref(u, amp, nu)
    return matern_corr_cuda(u.contiguous(), amp, nu=nu)


def tlr_mm(u_a, v_a, u_b, v_b, acc, *, out=None) -> torch.Tensor:
    """acc - U_a (V_a^T V_b) U_b^T for a batch of tile pairs.  With ``out``
    the result is written there and returned; ``out`` may be ``acc``
    itself (the update in place) and may share memory with nothing else."""
    if _on_cpu(acc, "tlr_mm"):
        res = ref.tlr_mm_ref(u_a, v_a, u_b, v_b, acc)
        if out is None:
            return res
        factors = (("u_a", u_a), ("v_a", v_a), ("u_b", u_b), ("v_b", v_b))
        check_out(out, acc, factors)
        return out.copy_(res)
    return tlr_mm_cuda(u_a, v_a, u_b, v_b, acc, out=out)


def potrf(a) -> torch.Tensor:
    """Lower Cholesky factors of a (B, nb, nb) batch of SPD tiles; a tile
    with a pivot that is not positive and finite comes back all NaN."""
    if _on_cpu(a, "potrf"):
        return ref.potrf_ref(a)
    return potrf_cuda(a.contiguous())


def trsm(lo, b) -> torch.Tensor:
    """X = L^{-1} B for lower L: lo (B or 1, nb, nb), b (B, nb, r)."""
    if _on_cpu(b, "trsm"):
        return ref.trsm_ref(lo, b)
    return trsm_cuda(lo.contiguous(), b.contiguous())


def syrk(c, a) -> torch.Tensor:
    """C - A A^T for a batch: c (B, nb, nb), a (B, nb, k).  On the card a
    ``c`` whose rows are strided is read in place, not copied."""
    if _on_cpu(c, "syrk"):
        return ref.syrk_ref(c, a)
    if c.dim() == 3 and c.stride(-1) != 1:
        c = c.contiguous()
    if a.dim() == 3 and a.stride(-1) != 1 and a.stride(-2) != 1:
        a = a.contiguous()
    return syrk_cuda(c, a)


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

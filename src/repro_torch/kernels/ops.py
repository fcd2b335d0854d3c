"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro.kernels.ops`` (its ``_mode``).  The tensors' device
decides: a CUDA tensor launches the hand kernel, which raises if it cannot
be built or launched; a CPU tensor takes the plain PyTorch version.  There
is no fallback from one to the other.  Each CUDA wrapper counts its
launches (``launch_counts``), so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import torch

from . import ref
from .chol_tiles import potrf_cuda, syrk_cuda, trsm_cuda
from .matern_tile import matern_tile_cuda
from .tlr_mm import tlr_mm_cuda

_WRAPPERS = {
    "matern_tile": matern_tile_cuda,
    "tlr_mm": tlr_mm_cuda,
    "potrf": potrf_cuda,
    "trsm": trsm_cuda,
    "syrk": syrk_cuda,
}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def matern_tile(locs_a, locs_b, inv_range, amp, *, nu: float) -> torch.Tensor:
    """C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range), nu in {0.5, 1.5, 2.5}."""
    if _on_cpu(locs_a, "matern_tile"):
        return ref.matern_tile_ref(locs_a, locs_b, inv_range, amp, nu)
    return matern_tile_cuda(locs_a, locs_b, inv_range, amp, nu=nu)


def tlr_mm(u_a, v_a, u_b, v_b, acc) -> torch.Tensor:
    """acc - U_a (V_a^T V_b) U_b^T for a batch of tile pairs."""
    if _on_cpu(acc, "tlr_mm"):
        return ref.tlr_mm_ref(u_a, v_a, u_b, v_b, acc)
    return tlr_mm_cuda(u_a, v_a, u_b, v_b, acc)


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


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0

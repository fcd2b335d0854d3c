"""Deterministic fault injection for the TLR pipeline (tests and chip runs).

Counterpart of ``repro.testing.faultinject``.  The robustness machinery
(``core.recovery.FactorStatus``, the jitter ladder, serving's health
checks) needs *reproducible* breakdowns to be testable.  This module
patches the three compress entry points, which their callers look up in
their modules at each call:

  * ``repro_torch.core.tlr.tlr_compress_tiles``        (single-program path)
  * ``repro_torch.core.dist_tlr.dist_compress_tiles``  (distributed forms)
  * ``repro_torch.serving.cokrige_service.dist_compress_tiles`` (serving fit)

so the tiles they return are corrupted in a controlled way before the
factorization sees them.  Each transform builds new tensors (a clone, then
the change) and never writes into the compress output.  The port has no
jit: a patch reaches every call made inside its ``with`` block, wherever
the calling function was defined, and none made after it.

A patch is per process: on a mesh (``launch.mesh``) each rank enters it
itself.  The sharded compression reaches the same sites, and a ``PairTLR``
that holds a rank's own slots (``shard`` set) is corrupted at the same
global slots as the whole one: a rank changes only the slots it holds, so
the ranks together inject the single-device fault.

Context managers (composable: they nest, and each restores the functions
it replaced on exit and on an exception):

  * ``corrupt_diag_tile(tile, magnitude)`` — subtract ``magnitude * I``
    from one diagonal tile: a clean non-PSD breakdown (POTRF pivot < 0).
  * ``nan_compress_panel(panel)`` — overwrite one U factor slot with NaN
    (a row of tiles of a ``TLRMatrix``, one pair of a ``PairTLR``): a
    poisoned low-rank stream (non-finite recompress singular values).  Row
    0 of a ``TLRMatrix`` holds no tile: poisoning it raises.
  * ``zero_shard(shard, n_shards)`` — zero every diagonal tile and U/V slot
    a block-cyclic shard would own (slots ``shard::n_shards``): the
    lost-device scenario (POTRF pivot exactly 0 on the zeroed tiles).

Pytest fixtures of the same names (suffix ``_fault``) are exported when
pytest is importable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..core import dist_tlr as _dist_mod
from ..core import tlr as _tlr_mod
from ..serving import cokrige_service as _serve_mod

__all__ = ["corrupt_diag_tile", "nan_compress_panel", "zero_shard"]

_PATCH_SITES = (
    (_tlr_mod, "tlr_compress_tiles"),
    (_dist_mod, "dist_compress_tiles"),
    (_serve_mod, "dist_compress_tiles"),
)


def _global_slots(t) -> torch.Tensor | None:
    """The global slot of each pair slot a ``PairTLR`` holding one rank's
    own slots holds (None for every other form)."""
    shard = getattr(t, "shard", None)
    if shard is None:
        return None
    pps = t.u.shape[0]
    return shard * pps + torch.arange(pps, device=t.u.device)


def _replace_fields(t, **kw):
    """_replace for NamedTuples (TLRMatrix) and dataclasses (PairTLR)."""
    if hasattr(t, "_replace"):
        return t._replace(**kw)
    return dataclasses.replace(t, **kw)


@contextlib.contextmanager
def _patch_compress(transform):
    """Route every compress entry point's output through ``transform``."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in _PATCH_SITES]

    def wrap(fn):
        def wrapped(*args, **kwargs):
            return transform(fn(*args, **kwargs))

        return wrapped

    try:
        for mod, name, fn in originals:
            setattr(mod, name, wrap(fn))
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


@contextlib.contextmanager
def corrupt_diag_tile(tile: int = 0, magnitude: float = 10.0):
    """Make diagonal tile ``tile`` non-PSD: D_tt -= magnitude * I.

    With ``magnitude`` above the tile's smallest eigenvalue the POTRF step
    at that tile produces a non-positive (or NaN) pivot:
    ``FactorStatus.breakdown_count > 0`` and ``status.ok == False``.
    """

    def transform(t):
        diag = t.diag.clone()
        nb = diag.shape[-1]
        diag[tile] -= magnitude * torch.eye(nb, dtype=diag.dtype, device=diag.device)
        return _replace_fields(t, diag=diag)

    with _patch_compress(transform):
        yield


@contextlib.contextmanager
def nan_compress_panel(panel: int = 0):
    """Overwrite low-rank factor slot ``panel`` with NaN.

    Models a corrupted compression stream: the NaNs reach the GEMM-phase
    recompress, whose non-finite singular-value count feeds
    ``FactorStatus.nonfinite_count``.  In the grid form (``TLRMatrix``)
    slot ``panel`` is the row of tiles ``(panel, j < panel)``, so row 0
    holds no tile: poisoning it would inject nothing, and the compress call
    raises ``ValueError`` instead (the reference injects nothing there).
    Every slot of the pair-major form (``PairTLR``) holds a tile.
    """

    def transform(t):
        if t.u.ndim == 4 and panel % t.u.shape[0] == 0:
            raise ValueError(
                f"nan_compress_panel({panel}): row {panel} of the grid form "
                "holds no tile below the diagonal, so nothing would be "
                "poisoned; pick a row >= 1 or the pair-major form"
            )
        u = t.u.clone()
        held = _global_slots(t)
        if held is None:
            u[panel] = math.nan
        else:
            u[held == panel] = math.nan
        return _replace_fields(t, u=u)

    with _patch_compress(transform):
        yield


@contextlib.contextmanager
def zero_shard(shard: int = 0, n_shards: int = 8):
    """Zero every tile a block-cyclic shard would own (lost device).

    Diagonal tiles ``shard::n_shards`` and U/V slots ``shard::n_shards`` go
    to zero; Cholesky of a zero tile yields pivot 0, so the breakdown is
    flagged (``min_pivot == 0``) without any NaN involved.
    """

    def transform(t):
        parts = {}
        held = _global_slots(t)
        for name in ("diag", "u", "v"):
            x = getattr(t, name).clone()
            if held is None or name == "diag":
                x[shard::n_shards] = 0.0
            else:
                x[held % n_shards == shard] = 0.0
            parts[name] = x
        return _replace_fields(t, **parts)

    with _patch_compress(transform):
        yield


try:  # pytest fixtures (only when pytest is importable)
    import pytest

    @pytest.fixture
    def corrupt_diag_fault():
        with corrupt_diag_tile():
            yield

    @pytest.fixture
    def nan_panel_fault():
        """``nan_compress_panel(0)``: slot 0 of the pair-major form; on the
        grid form row 0 holds no tile and the compress call raises."""
        with nan_compress_panel():
            yield

    @pytest.fixture
    def zero_shard_fault():
        with zero_shard():
            yield

    __all__ += ["corrupt_diag_fault", "nan_panel_fault", "zero_shard_fault"]
except ImportError:  # pragma: no cover
    pass

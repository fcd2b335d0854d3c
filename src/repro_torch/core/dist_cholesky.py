"""Exact blocked right-looking Cholesky in panel form, on one device (the
paper's CHAMELEON/ScaLAPACK role).

Counterpart of ``repro.core.dist_cholesky`` with ``mesh=None``.  The
reference's static schedule is a Python loop over panels; each step runs

  POTRF  the (panel x panel) head of the trailing matrix (``potrf`` kernel),
  TRSM   the (rest x panel) column panel, pan = rest L_kk^{-T}, computed as
         (L_kk^{-1} rest^T)^T (``trsm`` kernel, which solves from the left),
  SYRK   the trailing update trail[panel:, panel:] - pan pan^T, the O(m^3)
         term (``syrk`` kernel).

The factor is a list of (L_kk, panel) pairs: the trailing matrix shrinks
every step and is never written back into an (m, m) buffer.  On the card
the SYRK reads the previous trail's trailing block in place and writes the
new trail, so a step holds two trails at once, as the reference's
stateless form does.  The products of the solves stay ``torch.matmul``, as
the reference leaves them to XLA.  Given a ``times`` dict,
``dist_exact_loglik`` adds the seconds of ``gen``, ``factorize`` and
``solve`` to it, synchronising the device at each phase boundary.

Not ported: the multi-device forms (``mesh``; ROADMAP Queue 1 item 7) and
the dry-run lowerables ``dist_loglik_lowerable``, ``dist_cokrige_lowerable``
and ``dist_cholesky_lowerable`` (item 10).
"""

from __future__ import annotations

import math

import torch

from ..device import as_tensor
from ..kernels import ops
from .covariance import MaternParams, build_sigma
from .likelihood import LoglikResult
from .tlr import _lap


def _single_device(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            "mesh is not ported: the port's exact panel path runs on one "
            "device (the multi-device forms are ROADMAP Queue 1 item 7)"
        )


def blocked_cholesky_panels(
    a, panel: int, mesh=None, row_axes=("data",), *, device=None
):
    """Lower Cholesky factor of ``a`` (m, m) as a list of (L_kk, panel)
    pairs, one per step of ``panel`` columns; the last pair's panel is None.

    A head block that is not positive definite gives a NaN L_kk, and the
    NaN flows through the later steps, as ``jnp.linalg.cholesky`` does in
    the reference.
    """
    _single_device(mesh)
    trail = as_tensor(a, device=device)
    m = trail.shape[0]
    if m % panel:
        raise ValueError(f"panel={panel} does not divide m={m}")
    nk = m // panel
    panels = []
    for k in range(nk):
        lkk = ops.potrf(trail[:panel, :panel][None])[0]
        if k + 1 < nk:
            rest = trail[panel:, :panel]
            pan = ops.trsm(lkk[None], rest.mT.contiguous()[None])[0].mT
            trail = ops.syrk(trail[panel:, panel:][None], pan[None])[0]
        else:
            pan = None
        panels.append((lkk, pan))
    return panels


def panels_logdet(panels) -> torch.Tensor:
    return 2.0 * sum(torch.sum(torch.log(torch.diagonal(lkk))) for lkk, _ in panels)


def _columns(x, like: torch.Tensor):
    x = as_tensor(x, device=like.device, dtype=like.dtype)
    return (x[:, None], True) if x.dim() == 1 else (x, False)


def panels_forward_solve(panels, z, panel: int) -> torch.Tensor:
    """Solve L alpha = z from the panel factor.  z: (m,) or (m, r)."""
    rest, single = _columns(z, panels[0][0])
    outs = []
    for lkk, pan in panels:
        blk = ops.trsm(lkk[None], rest[:panel][None])[0]
        outs.append(blk)
        if pan is not None:
            rest = rest[panel:] - pan @ blk
    out = torch.cat(outs, dim=0)
    return out[:, 0] if single else out


def panels_backward_solve(panels, y, panel: int) -> torch.Tensor:
    """Solve L^T x = y from the panel factor (for cokriging weights).  The
    transposed solve stays ``solve_triangular``, as in the reference."""
    y, single = _columns(y, panels[0][0])
    nk = len(panels)
    outs = [None] * nk
    for k in range(nk - 1, -1, -1):
        lkk, pan = panels[k]
        rhs = y[k * panel : (k + 1) * panel]
        if pan is not None:
            # subtract contributions of already-solved lower blocks.
            x_below = torch.cat(outs[k + 1 :], dim=0)
            rhs = rhs - pan.mT @ x_below
        outs[k] = torch.linalg.solve_triangular(lkk.mT, rhs, upper=True)
    out = torch.cat(outs, dim=0)
    return out[:, 0] if single else out


def blocked_cholesky(a, panel: int, mesh=None, row_axes=("data",), *, device=None):
    """Dense lower Cholesky factor (assembled from the panel form; used by
    tests and small problems — the likelihood path stays in panel form)."""
    a = as_tensor(a, device=device)
    panels = blocked_cholesky_panels(a, panel, mesh, row_axes)
    out = torch.zeros_like(a)
    for k, (lkk, pan) in enumerate(panels):
        r0 = k * panel
        out[r0 : r0 + panel, r0 : r0 + panel] = lkk
        if pan is not None:
            out[r0 + panel :, r0 : r0 + panel] = pan
    return out


def forward_substitution(lfac, z, panel: int, *, device=None) -> torch.Tensor:
    """Blocked forward solve L alpha = z from a dense factor (test path)."""
    lfac = as_tensor(lfac, device=device)
    m = lfac.shape[0]
    z, single = _columns(z, lfac)
    z = z.clone()
    out = torch.zeros_like(z)
    for k in range(m // panel):
        r0, r1 = k * panel, (k + 1) * panel
        blk = ops.trsm(lfac[r0:r1, r0:r1][None], z[r0:r1][None])[0]
        out[r0:r1] = blk
        if r1 < m:
            z[r1:] -= lfac[r1:, r0:r1] @ blk
    return out[:, 0] if single else out


def _dist_loglik_body(
    dists,
    z,
    params: MaternParams,
    nugget: float,
    panel: int,
    representation: str,
    mesh,
    row_axes=("data",),
    *,
    times: dict | None = None,
) -> LoglikResult:
    """GEN -> panel Cholesky -> forward solve; the factor stays in panel form."""
    _single_device(mesh)
    t0 = _lap(times, None, 0.0, dists)
    sigma = build_sigma(
        None, params, representation=representation, nugget=nugget, dists=dists
    )
    t0 = _lap(times, "gen", t0, sigma)
    panels = blocked_cholesky_panels(sigma, panel)
    del sigma
    t0 = _lap(times, "factorize", t0, panels[-1][0])
    alpha = panels_forward_solve(panels, z, panel)
    quad = torch.sum(alpha * alpha)
    logdet = panels_logdet(panels)
    m = z.shape[-1]
    ll = -0.5 * (m * math.log(2.0 * math.pi) + logdet + quad)
    _lap(times, "solve", t0, ll)
    return LoglikResult(ll, logdet, quad, None)


def dist_exact_loglik(
    dists,
    z,
    params: MaternParams,
    *,
    nugget: float = 1e-6,
    panel: int = 4096,
    mesh=None,
    representation: str = "I",
    device=None,
    times: dict | None = None,
) -> LoglikResult:
    """One exact MLE iteration (GEN + blocked POTRF/TRSM/SYRK + solve) — the
    unit benchmarked in the paper's Figs. 7-9.  ``panel`` must divide
    m = p n.  Numpy ``dists`` go to ``device``; the status field is None, as
    in the reference."""
    _single_device(mesh)
    dists = as_tensor(dists, device=device)
    z = as_tensor(z, device=dists.device, dtype=dists.dtype)
    return _dist_loglik_body(
        dists, z, params, nugget, panel, representation, mesh, times=times
    )

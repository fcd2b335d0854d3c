"""Exact blocked right-looking Cholesky in panel form, on one device or on a
device mesh (the paper's CHAMELEON/ScaLAPACK role).

Counterpart of ``repro.core.dist_cholesky``.  The reference's static
schedule is a Python loop over panels; each step runs

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

**On a mesh** (``mesh=`` a ``DeviceMesh``, ``launch.mesh``) the panel-row
blocks of the trailing matrix are dealt cyclically over the S ranks of the
pair axis (block row i to pair shard i mod S), and a rank holds only the
lower part of its own block rows: about m^2 / (2 S) entries, with no
redistribution as the trail shrinks.  A step k: the owner of block k runs
the POTRF and broadcasts L_kk; every rank solves its own rows of the panel
(``trsm``); one ``all_gather`` gives every rank the panel; every rank
updates its own rows, the ``syrk`` kernel on its diagonal blocks and
``addmm`` off them.  The reference instead keeps the trail GSPMD-sharded
``P(row, "model")`` and re-splits it every step (ROADMAP Queue 3).  The
factor comes back as (L_kk, own rows of the panel) pairs, L_kk on every
rank (``gather_panels`` assembles the whole panels for tests); the solves
take it as it is, broadcasting (forward) or summing (backward) one block a
step, and return the whole solution on every rank.  ``dist_exact_loglik``
builds only the rank's own block rows of Sigma, from the rectangular slice
of ``dists``, with the nugget on the global diagonal only.

Not ported: the dry-run lowerables ``dist_loglik_lowerable``,
``dist_cokrige_lowerable`` and ``dist_cholesky_lowerable`` (ROADMAP Queue 1
item 8, the tooling analogues).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor
from ..distribution.block_cyclic import PairShard, pair_shard
from ..kernels import ops
from ..launch.mesh import broadcast_
from .covariance import MaternParams, _pair_correlations, build_sigma
from .likelihood import LoglikResult
from .tlr import _lap


def blocked_cholesky_panels(
    a, panel: int, mesh=None, row_axes=("data",), *, device=None
):
    """Lower Cholesky factor of ``a`` (m, m) as a list of (L_kk, panel)
    pairs, one per step of ``panel`` columns; the last pair's panel is None.

    A head block that is not positive definite gives a NaN L_kk, and the
    NaN flows through the later steps, as ``jnp.linalg.cholesky`` does in
    the reference.  On a mesh each rank reads only its own block rows of
    ``a`` and each panel holds the rank's own rows (see the module
    docstring).
    """
    trail = as_tensor(a, device=device)
    m = trail.shape[0]
    if m % panel:
        raise ValueError(f"panel={panel} does not divide m={m}")
    shard = pair_shard(mesh, row_axes)
    if shard is not None:
        def rows(i):
            return trail[i * panel : (i + 1) * panel, : (i + 1) * panel]

        return _panels_on_ranks(rows, m, panel, shard, trail)
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


def _own_blocks(nk: int, shard: PairShard) -> list[int]:
    """The block rows of an nk-block matrix that this rank holds."""
    return list(range(shard.index, nk, shard.count))


def _gather_rows(own: torch.Tensor, k: int, nk: int, panel: int, shard: PairShard):
    """The whole panel of step k (block rows k+1..nk-1, in order) from every
    rank's own rows ``own`` (one ``all_gather``, each rank's rows padded to
    the largest count)."""
    S = shard.count
    most = max(len([i for i in range(r, nk, S) if i > k]) for r in range(S))
    parts = shard.gather_rows(own, most * panel)
    parts = parts.reshape((S, most, panel) + tuple(own.shape[1:]))
    blocks = np.arange(k + 1, nk)
    first = [next((i for i in range(r, nk, S) if i > k), nk) for r in range(S)]
    src = blocks % S
    pos = (blocks - np.take(first, src)) // S
    dev = own.device
    out = parts[torch.as_tensor(src, device=dev), torch.as_tensor(pos, device=dev)]
    return out.reshape((-1,) + tuple(own.shape[1:]))


def _panels_on_ranks(block_row, m: int, panel: int, shard: PairShard, like):
    """The mesh form of ``blocked_cholesky_panels``: ``block_row(i)`` gives
    this rank's block row i, columns 0..(i+1) panel (only its own rows are
    asked for), in the dtype and on the device of ``like``."""
    nk = m // panel
    mine = _own_blocks(nk, shard)
    off, diag = [], []
    for i in mine:
        r = block_row(i)
        off.append(r[:, : i * panel].clone())
        diag.append(r[:, i * panel :])
    diag = torch.stack(diag) if mine else None
    panels = []
    for k in range(nk):
        owner = k % shard.count
        if owner == shard.index:
            lkk = ops.potrf(diag[mine.index(k)][None])[0]
        else:
            lkk = torch.empty((panel, panel), dtype=like.dtype, device=like.device)
        broadcast_(lkk, shard.ranks[owner], group=shard.group)
        if k + 1 == nk:
            panels.append((lkk, None))
            break
        below = [n for n, i in enumerate(mine) if i > k]
        pan = like.new_zeros((0, panel))
        if below:
            rest = torch.cat([off[n][:, k * panel : (k + 1) * panel] for n in below])
            pan = ops.trsm(lkk[None], rest.mT.contiguous()[None])[0].mT
        full = _gather_rows(pan, k, nk, panel, shard)
        if below:
            own = pan.reshape(len(below), panel, panel)
            live = torch.as_tensor(below, device=pan.device)
            diag[live] = ops.syrk(diag[live], own)
            for b, n in enumerate(below):
                i = mine[n]
                if i > k + 1:
                    cols = off[n][:, (k + 1) * panel : i * panel]
                    cols.addmm_(own[b], full[: (i - k - 1) * panel].mT, alpha=-1.0)
        panels.append((lkk, pan))
    return panels


def gather_panels(panels, panel: int, mesh, row_axes=("data",)):
    """The whole (L_kk, panel) pairs, on every rank, of a mesh factor whose
    panels hold each rank's own rows (``all_gather``)."""
    shard = pair_shard(mesh, row_axes)
    if shard is None:
        return panels
    nk = len(panels)
    return [
        (lkk, None if pan is None else _gather_rows(pan, k, nk, panel, shard))
        for k, (lkk, pan) in enumerate(panels)
    ]


def panels_logdet(panels) -> torch.Tensor:
    return 2.0 * sum(torch.sum(torch.log(torch.diagonal(lkk))) for lkk, _ in panels)


def _columns(x, like: torch.Tensor):
    x = as_tensor(x, device=like.device, dtype=like.dtype)
    return (x[:, None], True) if x.dim() == 1 else (x, False)


def panels_forward_solve(
    panels, z, panel: int, mesh=None, row_axes=("data",)
) -> torch.Tensor:
    """Solve L alpha = z from the panel factor.  z: (m,) or (m, r).  On a
    mesh (the panels holding each rank's own rows) the owner of block k
    solves it and broadcasts it; z and alpha are whole on every rank."""
    rest, single = _columns(z, panels[0][0])
    shard = pair_shard(mesh, row_axes)
    if shard is not None:
        out = _forward_on_ranks(panels, rest, panel, shard)
        return out[:, 0] if single else out
    outs = []
    for lkk, pan in panels:
        blk = ops.trsm(lkk[None], rest[:panel][None])[0]
        outs.append(blk)
        if pan is not None:
            rest = rest[panel:] - pan @ blk
    out = torch.cat(outs, dim=0)
    return out[:, 0] if single else out


def _forward_on_ranks(panels, z, panel: int, shard: PairShard) -> torch.Tensor:
    nk = len(panels)
    mine = _own_blocks(nk, shard)
    acc = torch.stack([z[i * panel : (i + 1) * panel] for i in mine]) if mine else None
    outs = []
    for k, (lkk, pan) in enumerate(panels):
        owner = k % shard.count
        if owner == shard.index:
            blk = ops.trsm(lkk[None], acc[mine.index(k)][None])[0]
        else:
            blk = torch.empty((panel, z.shape[1]), dtype=z.dtype, device=z.device)
        broadcast_(blk, shard.ranks[owner], group=shard.group)
        outs.append(blk)
        if pan is not None and pan.shape[0]:
            n = pan.shape[0] // panel
            acc[len(mine) - n :] -= (pan @ blk).reshape(n, panel, -1)
    return torch.cat(outs, dim=0)


def panels_backward_solve(
    panels, y, panel: int, mesh=None, row_axes=("data",)
) -> torch.Tensor:
    """Solve L^T x = y from the panel factor (for cokriging weights).  The
    transposed solve stays ``solve_triangular``, as in the reference.  On a
    mesh each rank sums its own rows' share of step k and one
    ``all_reduce`` adds them; x is whole on every rank."""
    y, single = _columns(y, panels[0][0])
    shard = pair_shard(mesh, row_axes)
    nk = len(panels)
    mine = [] if shard is None else _own_blocks(nk, shard)
    outs = [None] * nk
    for k in range(nk - 1, -1, -1):
        lkk, pan = panels[k]
        rhs = y[k * panel : (k + 1) * panel]
        if shard is not None and pan is not None:
            part = torch.zeros_like(rhs)
            below = [outs[i] for i in mine if i > k]
            if below:
                part = pan.mT @ torch.cat(below, dim=0)
            rhs = rhs - shard.sum(part)
        elif pan is not None:
            # subtract contributions of already-solved lower blocks.
            x_below = torch.cat(outs[k + 1 :], dim=0)
            rhs = rhs - pan.mT @ x_below
        outs[k] = torch.linalg.solve_triangular(lkk.mT, rhs, upper=True)
    out = torch.cat(outs, dim=0)
    return out[:, 0] if single else out


def blocked_cholesky(a, panel: int, mesh=None, row_axes=("data",), *, device=None):
    """Dense lower Cholesky factor (assembled from the panel form; used by
    tests and small problems — the likelihood path stays in panel form).
    On a mesh the whole factor is assembled on every rank."""
    a = as_tensor(a, device=device)
    panels = blocked_cholesky_panels(a, panel, mesh, row_axes)
    panels = gather_panels(panels, panel, mesh, row_axes)
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


def _sigma_rows(
    dists, params: MaternParams, representation: str, nugget, r0: int, r1: int, c1: int
) -> torch.Tensor:
    """Rows [r0, r1), columns [0, c1) of ``build_sigma(dists=dists)``, from
    the distances of the locations they involve only, with the nugget on
    the global diagonal."""
    n, p = dists.shape[0], params.p
    rows, cols = np.arange(r0, r1), np.arange(c1)
    if representation.upper() == "I":
        (lr, vr), (lc, vc) = divmod(rows, p), divmod(cols, p)
    elif representation.upper() == "II":
        (vr, lr), (vc, lc) = divmod(rows, n), divmod(cols, n)
    else:
        raise ValueError(f"unknown representation {representation!r}")
    ur, ir = np.unique(lr, return_inverse=True)
    uc, ic = np.unique(lc, return_inverse=True)
    dev = dists.device
    idx = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    sub = dists[idx(ur)][:, idx(uc)]
    sig = torch.sqrt(params.sigma2)
    amp = sig[:, None] * sig[None, :]
    blocks = amp[:, :, None, None] * _pair_correlations(sub, params)
    out = blocks[idx(vr)[:, None], idx(vc)[None, :], idx(ir)[:, None], idx(ic)[None, :]]
    if nugget is not None:
        diag = np.arange(r0, min(r1, c1))
        out[idx(diag - r0), idx(diag)] += nugget
    return out


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
    """GEN -> panel Cholesky -> forward solve; the factor stays in panel
    form.  On a mesh each rank generates only its own block rows."""
    shard = pair_shard(mesh, row_axes)
    t0 = _lap(times, None, 0.0, dists)
    if shard is None:
        sigma = build_sigma(
            None, params, representation=representation, nugget=nugget, dists=dists
        )
        t0 = _lap(times, "gen", t0, sigma)
        panels = blocked_cholesky_panels(sigma, panel)
        del sigma
    else:
        m = dists.shape[0] * params.p
        if m % panel:
            raise ValueError(f"panel={panel} does not divide m={m}")

        def rows(i):
            r0, r1 = i * panel, (i + 1) * panel
            return _sigma_rows(dists, params, representation, nugget, r0, r1, r1)

        dtype = torch.promote_types(dists.dtype, params.sigma2.dtype)
        dtype = torch.promote_types(dtype, params.a.dtype)
        like = torch.empty((), dtype=dtype, device=dists.device)
        panels = _panels_on_ranks(rows, m, panel, shard, like)
    t0 = _lap(times, "factorize", t0, panels[-1][0])
    alpha = panels_forward_solve(panels, z, panel, mesh, row_axes)
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
    in the reference.  On a mesh (its "data" row axis, as the reference's
    GSPMD layout) the result is whole on every rank; ``times`` then counts
    the GEN of a rank's rows under ``factorize``, since the rows are
    generated as the factorization reaches them."""
    dists = as_tensor(dists, device=device)
    z = as_tensor(z, device=dists.device, dtype=dists.dtype)
    return _dist_loglik_body(
        dists, z, params, nugget, panel, representation, mesh, times=times
    )

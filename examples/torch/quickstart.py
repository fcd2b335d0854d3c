"""Quickstart on the PyTorch/CUDA port: simulate a bivariate Matérn field,
evaluate the likelihood, compress to TLR, and compare exact vs TLR
log-likelihoods (the counterpart of examples/quickstart.py).

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # the CPU

On the card GEN runs the matern_corr kernel and the TLR factorization the
potrf, trsm and tlr_mm kernels; on the CPU their plain versions.  The
field's normal draws are made on the CPU from a seed, so both devices
simulate the same field.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    MaternParams,
    exact_loglik,
    pairwise_distances,
    simulate_mgrf,
)
from repro_torch.core import tlr as T
from repro_torch.core.covariance import build_sigma, morton_order
from repro_torch.core.simulate import grid_locations
from repro_torch.device import as_tensor, resolve_device

NUGGET = 1e-10
LEVELS = (("TLR5", 1e-5), ("TLR7", 1e-7), ("TLR9", 1e-9))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--n-side", type=int, default=20, help="n = n_side^2")
    ap.add_argument("--tile", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. Locations (Morton-ordered: the paper's TLR preprocessing).
    locs = grid_locations(args.n_side, jitter=0.3, seed=0)
    locs = locs[morton_order(locs)]
    print(f"{len(locs)} locations on the unit square")

    # 2. The parsimonious bivariate Matérn of Fig. 12.
    params = MaternParams.bivariate(
        sigma11=1.0, sigma22=1.0, a=0.2, nu11=0.5, nu22=1.0, beta=0.5, device=dev
    )

    # 3. Exact simulation.
    eps = torch.randn(
        (1, 2 * len(locs)),
        generator=torch.Generator().manual_seed(0),
        dtype=torch.float64,
    )
    z = simulate_mgrf(None, locs, params, nugget=NUGGET, eps=eps, device=dev)[0]
    z_var = float(torch.var(z, correction=0))
    print(f"simulated Z: shape {tuple(z.shape)}, var ~ {z_var:.2f}")

    # 4. Exact log-likelihood (Eq. 1).
    dists = pairwise_distances(as_tensor(locs, device=dev))
    ll = float(exact_loglik(None, z, params, dists=dists, nugget=NUGGET).loglik)
    print(f"exact loglik   = {ll:.4f}")

    # 5. TLR compression + TLR likelihood at the three paper accuracies.
    sigma = build_sigma(None, params, dists=dists, nugget=NUGGET)
    out = dict(n=len(locs), z=z.cpu().numpy(), z_var=z_var, exact_loglik=ll, tlr={})
    for name, tol in LEVELS:
        t = T.tlr_compress(sigma, tile_size=args.tile, tol=tol, max_rank=64)
        mem = T.memory_footprint(t)
        ll_tlr = float(
            T.tlr_loglik(
                dists,
                z,
                params,
                tol=tol,
                max_rank=64,
                tile_size=args.tile,
                nugget=NUGGET,
            ).loglik
        )
        print(
            f"{name}: loglik = {ll_tlr:.4f} "
            f"(err {abs(ll_tlr - ll):.2e}), "
            f"memory {mem['tlr_bytes'] / 1e6:.1f} MB vs dense "
            f"{mem['dense_bytes'] / 1e6:.1f} MB ({mem['ratio']:.2f}x)"
        )
        out["tlr"][name] = dict(loglik=ll_tlr, err=abs(ll_tlr - ll), **mem)
    del sigma
    return out


if __name__ == "__main__":
    main()

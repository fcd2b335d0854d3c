"""TLR vs exact likelihood accuracy ladder on the PyTorch/CUDA port (paper
Experiment 2, reduced n; the counterpart of examples/tlr_vs_exact.py).

Sweeps the spatial dependence strength (the paper's key variable) and shows
TLR5 breaking down under strong dependence while TLR9 tracks the exact
likelihood: the paper's Fig. 13 mechanism.

The TLR column uses the generator-direct pipeline (``from_tiles=True``):
the tiles are compressed straight from the Matérn generator over
Morton-ordered locations, never forming the dense Sigma.  ``gen="kernel"``
(the reference's ``"pallas"``) makes the tiles with the matern_tile kernel
on the card, at every order (its general instance for nu12 = 0.75); on the
CPU it takes the kernel's plain version.  The ``tiles-dense`` column checks
that the two compression paths agree.

  PYTHONPATH=src python examples/torch/tlr_vs_exact.py               # the card
  PYTHONPATH=src python examples/torch/tlr_vs_exact.py --device cpu  # the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    MaternParams,
    exact_loglik,
    pairwise_distances,
    simulate_mgrf,
)
from repro_torch.core import tlr as T
from repro_torch.core.covariance import morton_order
from repro_torch.core.simulate import grid_locations
from repro_torch.device import as_tensor, resolve_device

NUGGET = 1e-8
STRENGTHS = ((0.03, "weak"), (0.09, "moderate"), (0.2, "strong"))
LEVELS = (("TLR5", 1e-5), ("TLR7", 1e-7), ("TLR9", 1e-9))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--n-side", type=int, default=18, help="n = n_side^2")
    ap.add_argument("--tile", type=int, default=108)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    locs = grid_locations(args.n_side, jitter=0.2, seed=0)
    locs = locs[morton_order(locs)]
    dists = pairwise_distances(as_tensor(locs, device=dev))
    eps = torch.randn(
        (1, 2 * len(locs)),
        generator=torch.Generator().manual_seed(1),
        dtype=torch.float64,
    )
    kw = dict(max_rank=64, tile_size=args.tile, nugget=NUGGET)

    print(
        f"{'ER':>8} {'accuracy':>9} {'loglik err':>12} {'tiles-dense':>12} "
        f"{'mean rank':>10} {'mem ratio':>10}"
    )
    out = dict(n=len(locs), rows=[])
    for a, er in STRENGTHS:
        params = MaternParams.bivariate(a=a, nu11=0.5, nu22=1.0, beta=0.5, device=dev)
        z = simulate_mgrf(None, locs, params, nugget=NUGGET, eps=eps, device=dev)[0]
        ll_exact = float(
            exact_loglik(None, z, params, dists=dists, nugget=NUGGET).loglik
        )
        for name, tol in LEVELS:
            # generator-direct: tiles straight from the Matérn generator,
            # dense Sigma never built (gen="kernel" -> matern_tile kernel).
            t = T.tlr_compress_tiles(
                locs, params, tol=tol, gen="kernel", device=dev, **kw
            )
            ll = float(
                T.tlr_loglik(
                    None,
                    z,
                    params,
                    tol=tol,
                    locs=locs,
                    from_tiles=True,
                    gen="kernel",
                    device=dev,
                    **kw,
                ).loglik
            )
            ll_dense = float(T.tlr_loglik(dists, z, params, tol=tol, **kw).loglik)
            ranks = t.ranks.cpu().numpy()
            mean_rank = float(ranks[np.tril_indices(t.n_tiles, -1)].mean())
            mem = T.memory_footprint(t)
            print(
                f"{er:>8} {name:>9} {abs(ll - ll_exact):12.3e} "
                f"{abs(ll - ll_dense):12.3e} {mean_rank:10.1f} "
                f"{mem['ratio']:10.2f}"
            )
            out["rows"].append(
                dict(
                    a=a,
                    er=er,
                    accuracy=name,
                    z=z.cpu().numpy(),
                    exact_loglik=ll_exact,
                    loglik=ll,
                    loglik_dense=ll_dense,
                    loglik_err=abs(ll - ll_exact),
                    tiles_dense=abs(ll - ll_dense),
                    mean_rank=mean_rank,
                    mem_ratio=mem["ratio"],
                )
            )
    return out


if __name__ == "__main__":
    main()

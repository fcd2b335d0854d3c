"""End-to-end pipeline on the PyTorch/CUDA port (the paper's kind of
workload): simulate -> estimate -> cokrige -> assess; the counterpart of
examples/bivariate_fit_predict.py.

Runs the full pipeline of the paper on a reduced problem: MLE of the
parsimonious bivariate Matérn (profile likelihood + Nelder-Mead), cokriging
at held-out locations, MSPE, and the multivariate MLOE/MMOM criteria
comparing the estimated model against the truth.

  PYTHONPATH=src python examples/torch/bivariate_fit_predict.py [--n 300] [--tlr]
  PYTHONPATH=src python examples/torch/bivariate_fit_predict.py --device cpu

On the card GEN runs the matern_corr kernel and, with ``--tlr``, the TLR7
factorization the potrf, trsm and tlr_mm kernels.  The field's normal draws
are made on the CPU from a seed, so every device simulates the same field.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    MaternParams,
    cokrige_and_score,
    mloe_mmom,
    simulate_mgrf,
    split_train_pred,
    uniform_locations,
)
from repro_torch.core.mle import (
    MLEConfig,
    apply_morton,
    fit,
    initial_guess,
    make_objective,
    pack_params,
)
from repro_torch.device import resolve_device


def problem(n: int, npred: int, device):
    """The script's field: the true parameters, then the observed and the
    held-out locations and values, and the whole field z."""
    truth = MaternParams.bivariate(
        sigma11=1.0, sigma22=1.0, a=0.09, nu11=0.5, nu22=1.0, beta=0.5, device=device
    )
    locs = uniform_locations(n + npred, seed=0)
    eps = torch.randn(
        (1, 2 * len(locs)),
        generator=torch.Generator().manual_seed(0),
        dtype=torch.float64,
    )
    z = simulate_mgrf(None, locs, truth, nugget=1e-10, eps=eps, device=device)[0]
    obs, z_obs, pred, z_pred, *_ = split_train_pred(locs, z, npred, seed=0, p=2)
    return truth, obs, z_obs, pred, z_pred, z


def mle_config(backend: str, tile: int, max_iters: int) -> MLEConfig:
    """The script's estimation: profile likelihood, exact or TLR7."""
    return MLEConfig(
        p=2,
        profile=True,
        backend=backend,
        tlr_tol=1e-7,
        tlr_max_rank=32,
        tile_size=tile,
        max_iters=max_iters,
        nugget=1e-8,
    )


def objective(obs, z_obs, cfg: MLEConfig, device):
    """The negative profile loglik on the Morton order ``fit`` evaluates in."""
    return make_objective(*apply_morton(obs, z_obs, 2), cfg, device=device)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--npred", type=int, default=30)
    ap.add_argument(
        "--tlr",
        action="store_true",
        help="estimate with the TLR7 backend instead of exact",
    )
    ap.add_argument("--max-iters", type=int, default=80)
    ap.add_argument("--tile", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    truth, obs, z_obs, pred, z_pred, z = problem(args.n, args.npred, dev)
    print(f"n={args.n} observation / {args.npred} prediction locations")

    backend = "tlr" if args.tlr else "exact"
    cfg = mle_config(backend, args.tile, args.max_iters)
    loglik_start = -float(objective(obs, z_obs, cfg, dev)(initial_guess(2, True)))
    t0 = time.time()
    res = fit(obs, z_obs, cfg, device=dev)
    fit_s = time.time() - t0
    est = res.params
    sigma2 = est.sigma2.cpu().numpy()
    nu = est.nu.cpu().numpy()
    print(
        f"[{backend}] MLE finished in {fit_s:.1f}s "
        f"({int(res.n_evals)} likelihood evaluations)"
    )
    print(f"  sigma2 = {sigma2.round(3)} (truth 1, 1)")
    print(f"  a      = {float(est.a):.4f} (truth 0.09)")
    print(f"  nu     = {nu.round(3)} (truth 0.5, 1.0)")
    print(f"  beta   = {float(est.beta[0, 1]):.3f} (truth 0.5)")
    print(f"  loglik = {float(res.loglik):.2f}")

    score = cokrige_and_score(obs, z_obs, pred, z_pred, est, nugget=1e-8, device=dev)
    mspe_per_var = score.mspe_per_var.cpu().numpy()
    print(
        f"cokriging MSPE = {float(score.mspe):.4f} "
        f"(per variable {mspe_per_var.round(4)})"
    )

    crit = mloe_mmom(obs, pred, truth, est, nugget=1e-8, device=dev)
    print(
        f"MLOE^CK = {float(crit.mloe):.4f}  MMOM^CK = {float(crit.mmom):.4f} "
        "(0 = exact-model efficiency)"
    )
    return dict(
        backend=backend,
        z=z.cpu().numpy(),
        fit_s=fit_s,
        n_evals=int(res.n_evals),
        n_iters=int(res.n_iters),
        loglik_start=loglik_start,
        loglik=float(res.loglik),
        x=pack_params(est, True).cpu().tolist(),
        sigma2=sigma2,
        a=float(est.a),
        nu=nu,
        beta=float(est.beta[0, 1]),
        mspe=float(score.mspe),
        mspe_per_var=mspe_per_var,
        mloe=float(crit.mloe),
        mmom=float(crit.mmom),
    )


if __name__ == "__main__":
    main()

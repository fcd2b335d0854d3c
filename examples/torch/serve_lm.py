"""Serve a small model with batched requests on the PyTorch/CUDA port: a
cached prefill, then a greedy decode loop (the counterpart of
examples/serve_lm.py).

Shows the serving engine on each cache family: dense KV (qwen3), the
sliding-window ring (mixtral, whose MoE layers route dropless there), and
O(1) recurrent state (mamba2, recurrentgemma).  Any of the ten LM
architectures, at its reduced CPU-test size, with random weights.

  PYTHONPATH=src python examples/torch/serve_lm.py [--arch mixtral-8x7b]
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import LM_ARCH_NAMES, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serving.engine import make_serve_fns


def build(arch: str, batch: int, prompt_len: int, seed: int, device):
    """(reduced cfg, model with weights from a generator seeded with
    ``seed`` on ``device``, prompts (batch, prompt_len) drawn with numpy)."""
    dev = resolve_device(device)
    cfg = get_arch(arch).reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_model(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    return cfg, model, torch.as_tensor(prompts, device=dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=sorted(LM_ARCH_NAMES))
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg, model, prompts = build(
        args.arch, args.batch, args.prompt_len, args.seed, args.device
    )
    dev = prompts.device
    prefill, serve_step = make_serve_fns(cfg, args.prompt_len + args.steps)
    t0 = time.perf_counter()
    state, _ = prefill(model, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        toks.append(state.last_tokens)
        state, _ = serve_step(model, state)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.stack(toks, dim=1).cpu()
    print(f"arch={cfg.name} batch={args.batch} device={dev}")
    print(f"prefill {args.prompt_len} tokens: {t_prefill * 1e3:.1f} ms")
    print(
        f"decode {args.steps} steps: {t_decode * 1e3:.1f} ms "
        f"({t_decode / args.steps * 1e3:.1f} ms/token)"
    )
    print("generated token ids (first sequence):", out[0][:12].tolist(), "...")
    return dict(
        arch=cfg.name,
        prompts=prompts.cpu(),
        tokens=out,
        prefill_s=t_prefill,
        decode_s_per_token=t_decode / args.steps,
    )


if __name__ == "__main__":
    main()

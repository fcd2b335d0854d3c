"""Train a language model end to end on the PyTorch/CUDA port: the train
step (AdamW with an f32 master copy, per-block remat), checkpointing, the
fault-tolerant loop and deterministic data (the counterpart of
examples/train_lm.py, on one device).

Default: the reduced qwen3-family model (2 layers, d 128) for 100 steps at
batch 8 x 128 tokens.  ``--full`` scales to about 100M parameters x 300
steps at 8 x 512.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 100] [--arch qwen3-4b]
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.dataio.tokens import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainConfig, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument(
        "--full",
        action="store_true",
        help="~100M params x 300 steps instead of the reduced run",
    )
    ap.add_argument("--ckpt-dir", default=None, help="default: under TMPDIR")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_train_lm")

    cfg = get_arch(args.arch).reduced()
    if args.full:
        cfg = dataclasses.replace(
            cfg,
            d_model=512,
            d_ff=2048,
            num_layers=12,
            vocab_size=32000,
            num_heads=8,
            num_kv_heads=4,
            head_dim=64,
        )
        args.steps = max(args.steps, 300)
        seq, batch = 512, 8
    else:
        seq, batch = 128, 8

    tcfg = TrainConfig(
        remat=True,
        attn_impl="chunked",
        optimizer=AdamWConfig(
            learning_rate=3e-3, warmup_steps=20, decay_steps=args.steps
        ),
    )
    step = make_train_step(cfg, None, tcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_model(cfg, generator=gen, device=dev)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={nparams / 1e6:.1f}M seq={seq} batch={batch}")

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    trainer = Trainer(
        step,
        model,
        data,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=max(args.steps // 4, 10),
            checkpoint_dir=ckpt_dir,
            log_every=10,
        ),
    )
    out = trainer.run(start_step=0)
    for m in out["log"]:
        print(
            f"step {m['step']:4d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.2f}  {m['dt'] * 1e3:.0f} ms"
        )
    print(f"finished at step {out['final_step']}; checkpoints in {ckpt_dir}")
    return dict(
        arch=cfg.name,
        device=str(dev),
        n_params=nparams,
        seq=seq,
        batch=batch,
        log=out["log"],
        final_step=out["final_step"],
        checkpoint_dir=ckpt_dir,
    )


if __name__ == "__main__":
    main()

"""Training launcher: the sharded train step on a mesh of ranks.

Counterpart of ``repro.launch.train``.  Every rank builds the model from
the seed, takes its shard (``distribution.sharding.shard_params``) and runs
the fault-tolerant ``Trainer`` over ``make_train_step(cfg, mesh, ...)``;
the global batch comes from the deterministic token source and each rank
keeps its rows (``shard_batch``).  Checkpoints are written whole by rank 0
and restore onto any mesh shape (``--resume``).

W ranks on this machine (``launch.mesh.spawn_ranks``):

  python -m repro_torch.launch.train --world 4 --arch qwen3-4b --reduced \\
      --steps 20 --seq-len 64 --global-batch 8 --ckpt-dir ck --device-type cpu

On the card: ``--device-type cuda`` (the default) with ``--backend nccl``
when each rank has its own GPU, or ``--backend gloo`` for several ranks on
one.  Under ``torchrun --nproc-per-node W -m repro_torch.launch.train ...``
the ranks come from torchrun's environment instead.  ``--mesh-shape 2,1,2``
gives a ("pod", "data", "model") mesh; the default is the reference's
("data", "model") shape rule for W.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get_arch
from ..dataio.tokens import SyntheticTokens
from ..distribution.sharding import param_shardings, shard_batch, shard_params
from ..models import init_model
from ..training.optimizer import AdamWConfig
from ..training.train_step import TrainConfig, make_train_step
from ..training.trainer import Trainer, TrainerConfig
from .mesh import axes_for, make_mesh, make_mesh_for_devices, spawn_ranks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default="naive", choices=["naive", "chunked"])
    ckpt = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ap.add_argument("--ckpt-dir", default=ckpt)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=1, help="ranks to start here")
    ap.add_argument("--mesh-shape", default=None, help="e.g. 2,2 or 2,1,2")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, help="nccl (cuda) or gloo (cpu)")
    return ap.parse_args(argv)


def _mesh_shape(opts):
    if opts.mesh_shape is None:
        return None
    return tuple(int(n) for n in opts.mesh_shape.split(","))


def train_on_mesh(mesh, opts) -> dict:
    """One rank of the run (``spawn_ranks``' rank body, or torchrun's)."""
    cfg = get_arch(opts.arch)
    if opts.reduced:
        cfg = cfg.reduced()
    dev = torch.device("cpu")
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    tcfg = TrainConfig(
        microbatches=opts.microbatches,
        attn_impl=opts.attn_impl,
        compress_cross_pod=opts.compress_grads,
        optimizer=AdamWConfig(learning_rate=opts.lr, decay_steps=opts.steps),
    )
    step = make_train_step(cfg, mesh, tcfg)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    model = shard_params(init_model(cfg, generator=gen, device=dev), cfg, mesh)
    errors = None
    if tcfg.compress_cross_pod:
        errors = [torch.zeros(p.shape, device=dev) for p in model.parameters()]
    data = SyntheticTokens(cfg.vocab_size, opts.seq_len, opts.global_batch)

    def step_fn(p, o, e, batch):
        return step(p, o, e, shard_batch(batch, mesh, tcfg.microbatches))

    trainer = Trainer(
        step_fn,
        model,
        data,
        TrainerConfig(
            total_steps=opts.steps,
            checkpoint_every=opts.ckpt_every,
            checkpoint_dir=opts.ckpt_dir,
        ),
        grad_errors=errors,
        shardings=param_shardings(model, cfg),
    )
    out = trainer.run(start_step=None if opts.resume else 0)
    return dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        final_step=out["final_step"],
        nan_restores=out["nan_restores"],
        stragglers=len(out["stragglers"]),
        last_losses=[m["loss"] for m in out["log"][-5:]],
    )


def _torchrun(opts) -> dict:
    """The rank's run under torchrun: its process group from the
    environment torchrun sets."""
    import torch.distributed as dist

    backend = opts.backend or ("nccl" if opts.device_type == "cuda" else "gloo")
    if opts.device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    try:
        shape = _mesh_shape(opts)
        if shape is None:
            mesh = make_mesh_for_devices(device_type=opts.device_type)
        else:
            mesh = make_mesh(shape, axes_for(shape), device_type=opts.device_type)
        return train_on_mesh(mesh, opts)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    opts = parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        out = _torchrun(opts)
        if int(os.environ["RANK"]) != 0:
            return out
    else:
        backend = opts.backend or ("nccl" if opts.device_type == "cuda" else "gloo")
        out = spawn_ranks(
            train_on_mesh,
            opts.world,
            args=(opts,),
            backend=backend,
            device_type=opts.device_type,
            mesh_shape=_mesh_shape(opts),
        )[0]
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()

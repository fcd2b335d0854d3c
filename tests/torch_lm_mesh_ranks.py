"""Rank bodies of tests/test_torch_lm_mesh.py (not collected by pytest).

The test starts 4 rank processes (``launch.mesh.spawn_ranks``) on a (2, 2)
("data", "model") mesh; each unpickles ``run_all`` from this module, so it
imports only numpy, torch and the port, never JAX.  ``run_all`` also builds
a (2, 1, 2) ("pod", "data", "model") mesh and a (4, 1) mesh over the same
ranks, runs every case once and returns what the parent asserts on, as
numpy.  The weights come in as the port's parameters by name (numpy),
carried from the reference's ``init_model`` by the parent.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# The batches: (rows, tokens) of the forward, the train steps' synthetic
# token stream (its sequence, global batch, seed) and the steps.
FWD_BATCH = (4, 16)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEED, TRAIN_STEPS = 16, 4, 4, 3


def config(arch: str, overrides: dict):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).reduced(), **overrides)


def forward_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size, size=FWD_BATCH).astype(np.int32)


def train_batches(cfg) -> list:
    from repro_torch.dataio.tokens import SyntheticTokens

    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED)
    return [data.batch(i) for i in range(TRAIN_STEPS)]


def model_from(cfg, state: dict):
    """The port's model holding ``state`` (numpy arrays by parameter name)."""
    from repro_torch.models import init_model

    model = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def dp_rows(mesh, rows: int) -> slice:
    """This rank's data-parallel rows of a batch of ``rows``."""
    from repro_torch.distribution.sharding import batch_axes
    from repro_torch.launch.mesh import axis_index, axis_size

    dp = batch_axes(mesh)
    n = rows // axis_size(mesh, dp)
    i = axis_index(mesh, dp)
    return slice(i * n, (i + 1) * n)


def tcfg_of(kw: dict):
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig

    return TrainConfig(remat=True, optimizer=AdamWConfig(), **kw)


def run_train(mesh, cfg, state: dict, kw: dict) -> dict:
    """TRAIN_STEPS steps of ``make_train_step(cfg, mesh, ...)`` (mesh None:
    the single-device step): each step's metrics, and the whole final
    parameters by name."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step

    tcfg = tcfg_of(kw)
    model = model_from(cfg, state)
    if mesh is not None:
        sh.shard_params(model, cfg, mesh)
    opt, errors = adamw_init(model), None
    step = make_train_step(cfg, mesh, tcfg)
    metrics = []
    # how often a compressed leaf's shard holds whole blocks (quantised in
    # place) and how often it does not (gathered first)
    whole_blocks = ts._whole_blocks
    branches = {True: 0, False: 0}

    def counted(*a, **k):
        out = whole_blocks(*a, **k)
        branches[out] += 1
        return out

    ts._whole_blocks = counted
    try:
        for b in train_batches(cfg):
            if mesh is not None:
                b = sh.shard_batch(b, mesh, tcfg.microbatches)
            model, opt, errors, m = step(model, opt, errors, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        ts._whole_blocks = whole_blocks
    params = sh.gather_params(model, cfg) if mesh is not None else dict(
        (n, p.detach()) for n, p in model.named_parameters()
    )
    return dict(
        metrics=metrics, params=params,
        in_place=branches[True], gathered=branches[False],
    )


def run_forward(mesh, cfg, state: dict, impl: str) -> dict:
    """The forward of ``forward_tokens`` (mesh None: on one device, each
    data-parallel block of rows alone): this rank's rows' whole logits and
    the aux loss."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.models import forward
    from repro_torch.models.settings import fsdp_gather

    tokens = torch.as_tensor(forward_tokens(cfg))
    model = model_from(cfg, state)
    with torch.no_grad():
        if mesh is None:
            outs = [
                forward(model, cfg, t, attn_impl=impl)
                for t in tokens.split(FWD_BATCH[0] // 2)
            ]
            return dict(
                logits=torch.cat([o.logits for o in outs]),
                aux=[float(o.aux_loss) for o in outs],
            )
        sh.shard_params(model, cfg, mesh)
        local = sh.shard_batch({"tokens": tokens}, mesh)["tokens"]
        with fsdp_gather(mesh):
            out = forward(model, cfg, local, attn_impl=impl)
        logits = sh.gather_logits(out.logits, cfg, mesh)
    rows = dp_rows(mesh, FWD_BATCH[0])
    return dict(logits=logits, aux=float(out.aux_loss), rows=rows)


def moe_input(cfg) -> np.ndarray:
    return np.random.default_rng(9).standard_normal(FWD_BATCH + (cfg.d_model,)).astype(
        np.float32
    )


def case_moe_block(mesh, cfg, state: dict) -> dict:
    """The first MoE layer's block alone on ``moe_input``: this rank's rows
    of y and the aux loss."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.models import settings
    from repro_torch.models.moe import moe_block
    from repro_torch.models.shardspecs import gather_layer_params

    model = sh.shard_params(model_from(cfg, state), cfg, mesh)
    layer = next(ly for ly in model.layers if ly.use_moe)
    x = torch.as_tensor(moe_input(cfg))[dp_rows(mesh, FWD_BATCH[0])]
    with torch.no_grad(), settings.fsdp_gather(mesh):
        w = gather_layer_params(layer, cfg, layer.kind, True, mesh)
        y, aux = moe_block(w.moe, x, cfg)
    return dict(y=y, aux=float(aux), rows=dp_rows(mesh, FWD_BATCH[0]))


def case_collectives(mesh) -> dict:
    """Each autograd collective's value and gradient against the same
    global objective computed whole in this process (float64): the largest
    gap of each."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm

    me, world = dist.get_rank(), dist.get_world_size()
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    data, mp = coord["data"], lm.axis_size(mesh, "model")

    def arr(seed, shape=(3, 5)):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))

    def grad_of(x, loss):
        return torch.autograd.grad(loss, x)[0]

    out = {}
    # all_gather over both axes (a built group), reduce-scatter backward:
    # L = sum_r <C_r, cat(x_0..x_3)>
    whole = lm.axis_group(mesh, ("data", "model"))
    x = arr(100 + me).requires_grad_()
    y = lm.gather_dim(x, 0, whole)
    g = grad_of(x, (arr(200 + me, (3 * world, 5)) * y).sum())
    csum = sum(arr(200 + r, (3 * world, 5)) for r in range(world))
    want_y = torch.cat([arr(100 + r) for r in range(world)])
    out["gather_sum"] = max(
        float((y - want_y).abs().max()),
        float((g - csum[3 * me : 3 * me + 3]).abs().max()),
    )
    # the ranks of a "model" group: members share "data"
    members = [r for r in range(world) if r // mp == data]
    mine = members.index(me)
    group = lm.axis_group(mesh, "model")
    # all_gather, slice backward: every member computes the same L = <c, y>
    x = arr(300 + me).requires_grad_()
    y = lm.gather_dim(x, 0, group, reduce_grad=False)
    c = arr(400 + data, (3 * mp, 5))
    g = grad_of(x, (c * y).sum())
    out["gather_slice"] = float((g - c[3 * mine : 3 * mine + 3]).abs().max())
    # copy into the region: x shared, L = sum_r <C_r, x>
    x = arr(500 + data).requires_grad_()
    g = grad_of(x, (arr(600 + me) * lm.copy_to_region(x, group)).sum())
    want = sum(arr(600 + r) for r in members)
    out["copy"] = float((g - want).abs().max())
    # the reduce out of the region: y = sum_r x_r, L = <c, y^2> (once)
    x = arr(700 + me).requires_grad_()
    y = lm.reduce_from_region(x, group)
    c = arr(800 + data)
    g = grad_of(x, (c * y * y).sum())
    want_y = sum(arr(700 + r) for r in members)
    out["reduce"] = max(
        float((y - want_y).abs().max()), float((g - 2 * c * want_y).abs().max())
    )
    return out


def case_api(meshes: dict) -> dict:
    """batch_axes and data_specs on the (2, 2) and pod meshes; a tensor
    constrained to ("data", "model") on (2, 2) (this rank's shard) and
    unsharded whole again."""
    from repro_torch.distribution import sharding as sh

    cfg = config("qwen3-4b", {})
    out = {}
    for key in ("2x2", "pod"):
        m = meshes[key]
        out[key] = dict(
            batch_axes=sh.batch_axes(m),
            train=sh.data_specs(cfg, m, "train", False),
            prefill_embeds=sh.data_specs(cfg, m, "prefill", True),
        )
    x = torch.arange(32.0).reshape(4, 8)
    placed = sh.shardings_of({"x": ("data", "model")}, meshes["2x2"])["x"]
    local = sh.constrain(x, meshes["2x2"], ("data", "model"))
    out.update(
        coordinate=tuple(meshes["2x2"].get_coordinate()),
        local=local,
        whole_again=bool(torch.equal(sh.unshard_tensor(local, placed), x)),
    )
    return out


def case_compressed_psum(pod_mesh) -> dict:
    """``compressed_psum`` over "pod" of two steps of leaves (the pods'
    gradients differ; the ranks of a pod hold the same), with the errors
    fed back: every step's means and this rank's errors."""
    from repro_torch.distribution.compression import compressed_psum

    pod = int(pod_mesh.get_coordinate()[0])
    shapes = [(16, 32), (7, 5), (300,)]
    errors, steps = None, []
    for step in range(2):
        rng = np.random.default_rng(50 + 10 * step + pod)
        grads = [
            torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes
        ]
        means, errors = compressed_psum(grads, pod_mesh, "pod", errors)
        steps.append(dict(means=means, errors=list(errors)))
    return dict(pod=pod, steps=steps)


def _opt_tree(model):
    """A whole trainer state of ``model``: AdamW at step 3 with moments
    made from the parameters, and compression errors."""
    from repro_torch.training.optimizer import AdamWState

    ps = [p.detach() for p in model.parameters()]
    state = AdamWState(
        torch.tensor(3, dtype=torch.int32),
        [p.clone() for p in ps],
        [0.5 * p for p in ps],
        [p * p for p in ps],
    )
    return dict(opt=state, errors=[p - 1.0 for p in ps])


def _state_shardings(mesh, model, cfg):
    from repro_torch.distribution.sharding import Sharding, param_specs
    from repro_torch.training.optimizer import AdamWState

    specs = param_specs(cfg)
    sh = [Sharding(mesh, specs[n]) for n, _ in model.named_parameters()]
    return dict(opt=AdamWState(Sharding(mesh, ()), sh, sh, sh), errors=sh)


def _mesh_trainer(model, cfg, mesh, directory):
    """A ``Trainer`` holding this rank's shards (its save gathers and rank 0
    writes)."""
    from repro_torch.distribution.sharding import param_shardings
    from repro_torch.training.trainer import Trainer, TrainerConfig

    return Trainer(
        None, model, None, TrainerConfig(checkpoint_dir=directory),
        shardings=param_shardings(model, cfg),
    )


def case_restore(meshes: dict, cfg, state: dict, tmp: str) -> dict:
    """Elastic restore, bit for bit: a whole checkpoint onto (2, 2); one
    saved from (2, 2) onto (4, 1) and onto one device; one saved from (4, 1)
    onto (2, 2).  For each, whether every leaf equals its shard of the
    whole state exactly."""
    import torch.distributed as dist

    from repro_torch.checkpointing.checkpoint import (
        _flatten_with_names,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.distribution.sharding import shard_params, shard_tensor
    from repro_torch.launch.mesh import all_reduce_

    whole_model = model_from(cfg, state)
    whole = _opt_tree(whole_model)

    def same(tree, target_mesh) -> bool:
        _, got, _ = _flatten_with_names(tree)
        _, full, _ = _flatten_with_names(whole)
        if target_mesh is None:
            return all(torch.equal(a, b) for a, b in zip(got, full, strict=True))
        placements = _state_shardings(target_mesh, whole_model, cfg)
        _, placed, _ = _flatten_with_names(placements)
        return all(
            torch.equal(a, shard_tensor(b, s))
            for a, b, s in zip(got, full, placed, strict=True)
        )

    def restore(directory, target_mesh):
        sh = None if target_mesh is None else _state_shardings(
            target_mesh, whole_model, cfg
        )
        tree, _ = restore_checkpoint(directory, whole, shardings=sh)
        return tree

    def save_from(mesh, directory):
        model = shard_params(model_from(cfg, state), cfg, mesh)
        trainer = _mesh_trainer(model, cfg, mesh, directory)
        tree = restore(os.path.join(tmp, "one"), mesh)  # this rank's shards
        trainer.opt_state, trainer.grad_errors = tree["opt"], tree["errors"]
        trainer.save(3)
        trainer.wait()

    out = {}
    if dist.get_rank() == 0:
        save_checkpoint(os.path.join(tmp, "one"), 3, whole)
    all_reduce_(torch.zeros(1))
    def moved(source, target):
        return same(restore(os.path.join(tmp, source), meshes.get(target)),
                    meshes.get(target))

    out["one_to_2x2"] = moved("one", "2x2")
    save_from(meshes["2x2"], os.path.join(tmp, "from_2x2"))
    out["2x2_to_4x1"] = moved("from_2x2", "4x1")
    out["2x2_to_one"] = moved("from_2x2", None)
    save_from(meshes["4x1"], os.path.join(tmp, "from_4x1"))
    out["4x1_to_2x2"] = moved("from_4x1", "2x2")
    return out


def run_trainer(cfg, state: dict, directory: str, meshes=(None, None)) -> dict:
    """The fault-tolerant trainer in two runs: 4 steps (a checkpoint every
    2) on ``meshes[0]``, then a new trainer on ``meshes[1]`` that resumes
    from the last checkpoint and runs to step 6 (None: one device).  The
    whole final checkpoint's master copy, by parameter order."""
    from repro_torch.checkpointing.checkpoint import restore_checkpoint
    from repro_torch.dataio.tokens import SyntheticTokens
    from repro_torch.distribution.sharding import (
        param_shardings,
        shard_batch,
        shard_params,
    )
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import Trainer, TrainerConfig

    tcfg = tcfg_of({})
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED)
    for total, mesh in zip((4, 6), meshes):
        model = model_from(cfg, state)
        if mesh is not None:
            shard_params(model, cfg, mesh)
        step = make_train_step(cfg, mesh, tcfg)

        def step_fn(p, o, e, b, mesh=mesh, step=step):
            return step(p, o, e, b if mesh is None else shard_batch(b, mesh))

        trainer = Trainer(
            step_fn, model, data,
            TrainerConfig(total_steps=total, checkpoint_every=2,
                          checkpoint_dir=directory),
            shardings=None if mesh is None else param_shardings(model, cfg),
        )
        res = trainer.run()
    model = model_from(cfg, state)
    tree, manifest = restore_checkpoint(
        directory, dict(opt=adamw_init(model), errors=None)
    )
    return dict(master=tree["opt"].master, step=int(tree["opt"].step),
                final_step=res["final_step"], resumed_at=manifest["step"])


def case_launcher(mesh, tmp: str) -> dict:
    """``launch.train.train_on_mesh`` (the launcher's rank body) for two
    steps of the reduced qwen3-4b on this mesh."""
    from repro_torch.launch.train import parse_args, train_on_mesh

    opts = parse_args([
        "--arch", "qwen3-4b", "--reduced", "--steps", "2", "--seq-len", "16",
        "--global-batch", "4", "--ckpt-every", "1", "--device-type", "cpu",
        "--ckpt-dir", os.path.join(tmp, "launcher"), "--compress-grads",
    ])
    return train_on_mesh(mesh, opts)


def run_all(mesh, payload: dict) -> dict:
    """Every case once.  ``payload``: ``archs`` (name -> (config overrides,
    the weights by name)), ``forward`` ((arch, impl) pairs), ``forward_pod``
    (archs also run on the pod mesh), ``train`` ((arch, overrides of the
    train steps) pairs, qwen3-4b first) and ``tmp`` (a directory every rank
    sees)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import POD_AXES, make_mesh

    meshes = {
        "2x2": mesh,
        "pod": make_mesh((2, 1, 2), POD_AXES, device_type="cpu"),
        "4x1": make_mesh((4, 1), ("data", "model"), device_type="cpu"),
    }
    archs, tmp = payload["archs"], payload["tmp"]
    rank0 = dist.get_rank() == 0

    def train(key, mesh_key, arch, extra, **kw):
        overrides, state = archs[arch]
        cfg = config(arch, {**overrides, **extra})
        res = run_train(meshes[mesh_key], cfg, state, kw)
        if not rank0:
            res.pop("params")  # the same on every rank: rank 0's is enough
        out["train"][key] = res

    out = {"rank": dist.get_rank(), "forward": {}, "moe": {}, "train": {}}
    out["collectives"] = case_collectives(mesh)
    out["api"] = case_api(meshes)
    for arch, impl in payload["forward"]:
        overrides, state = archs[arch]
        cfg = config(arch, overrides)
        out["forward"][arch] = run_forward(mesh, cfg, state, impl)
        if arch in payload["forward_pod"]:
            out["forward"][arch + "@pod"] = run_forward(meshes["pod"], cfg, state, impl)
        if cfg.moe:
            out["moe"][arch] = case_moe_block(mesh, cfg, state)
    for arch, extra in payload["train"]:
        train(arch, "2x2", arch, extra)
    qwen = payload["train"][0][0]
    train("microbatches", "2x2", qwen, {}, microbatches=2)
    train("pod", "pod", qwen, {})
    train("compress", "pod", qwen, {}, compress_cross_pod=True)
    out["compressed_psum"] = case_compressed_psum(meshes["pod"])
    overrides, state = archs[qwen]
    cfg = config(qwen, overrides)
    out["restore"] = case_restore(meshes, cfg, state, tmp)
    trained = run_trainer(cfg, state, os.path.join(tmp, "trainer"),
                          (meshes["2x2"], meshes["4x1"]))
    if not rank0:
        trained = {k: trained[k] for k in ("step", "final_step")}
    out["trainer"] = trained
    out["launcher"] = case_launcher(mesh, tmp)
    from repro_torch.distribution.sharding import shard_batch

    try:  # three rows over two data-parallel ranks
        shard_batch({"tokens": np.zeros((3, 4), np.int32)}, mesh)
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    return out

"""Dry-run of every production cell on a fake mesh of 256 or 512 ranks
(counterpart of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell one process traces
rank 0 of the production mesh, with no data:

  * a ``torch.distributed`` "fake" process group of 256 ranks ((16, 16)
    over ("data", "model")) or 512 ((2, 16, 16) over ("pod", "data",
    "model")), ``launch.mesh.make_production_mesh`` over it;
  * the model (sharded by ``distribution.sharding.shard_params``), its
    caches, optimizer state and inputs, or the geostatistics cell's
    inputs, built as fake tensors under ``FakeTensorMode`` at the rank's
    shard shapes, on the card's device unless ``device="cpu"`` is named;
  * the step run once under ``FlopCounterMode`` (matmul-family ops and the
    hand-written kernels' formulas, ``kernels.ops``; no SVD or QR), a byte
    counter over the dispatched operators (each one's tensor inputs and
    outputs, unfused: not XLA's fused "bytes accessed"; views, empty
    allocations, device queries and collectives left out),
    ``launch.mesh.count_collectives``
    (bytes by kind and by mesh axis) and a tracker of the live bytes of
    the rank's tensors, whose peak is what the rank would allocate
    (parameters, optimizer state and the rest; the allocator's rounding
    and fragmentation not included).

The record holds the peak bytes a rank and whether they fit the card's 80
GB, the FLOPs, bytes and collective bytes a rank, the three roofline terms
of ``launch.roofline`` (H100 datasheet constants) and the one that binds,
the analytic model FLOPs and the trace's seconds.  TLR cells add the
phases of ``tlr_phase_reports``.

Differences by design from the reference: XLA's cost analysis counts a loop
body once, so the reference extrapolates a full-depth model from one and
two pattern periods (``cost_extrapolated``, ``models.settings.
UNROLL_SCANS``); the port's layers are a Python loop that the trace sees
whole, so ``cost_correction`` is "none (every layer traced)".  The
collectives are counted where they are issued, not parsed from HLO.  MoE
dispatch runs at capacity (``models.settings.moe_at_capacity``), as the
reference's static (E C, d) buffer, since a fake tensor has no routing to
read (the record says so).  A train step skips its host check of a
non-finite loss (``train_step(check_finite=False)``).  Fake tensors carry
no values, so every data-dependent host read is gone from the traced
bodies: the lowerables are the bodies without the recovery ladder, as the
reference's, and small parameter tensors (the Matérn orders) are kept as
constants of the trace.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --all --device cpu   # without a card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

from ..configs import get_arch, get_shape, iter_cells
from ..configs.base import GeoStatConfig
from ..lowerables import Spec
from . import roofline as rl

# FlopCounterMode counts the out-of-place products only; the exact panel
# Cholesky updates its off-diagonal rows with addmm_, in place
for _op, _of in ((torch.ops.aten.addmm_, torch.ops.aten.addmm),
                 (torch.ops.aten.baddbmm_, torch.ops.aten.baddbmm)):
    register_flop_formula(_op, get_raw=True)(flop_counter.flop_registry[_of])

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"
)
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
COST_CORRECTION = "none (every layer traced)"


def _row_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


# ---------------------------------------------------------------------------
# input_specs: global (shape, dtype) stand-ins, no allocation
# ---------------------------------------------------------------------------


def input_specs(arch_name: str, shape_name: str) -> dict:
    """The global Spec of every input of the cell, as the reference's."""
    cfg = get_arch(arch_name)
    return cell_input_specs(cfg, get_shape(cfg, shape_name))


def cell_input_specs(cfg, shape) -> dict:
    """``input_specs`` of a config and a shape (objects)."""
    if isinstance(cfg, GeoStatConfig):
        m = shape.matrix_dim
        return dict(
            locs=Spec((shape.n_locations, 2), torch.float32),
            z=Spec((m,), torch.float32),
        )
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if shape.kind == "decode":
        if cfg.frontend == "none":
            specs["tokens"] = Spec((b,), torch.int32)
        else:
            specs["embeds"] = Spec((b, cfg.d_model), torch.bfloat16)
        return specs
    if cfg.frontend == "none":
        specs["tokens"] = Spec((b, s), torch.int32)
    else:
        specs["embeds"] = Spec((b, s, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        specs["targets"] = Spec((b, s), torch.int32)
    return specs


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------


_SKIPPED = {"detach", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense"}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counters(TorchDispatchMode):
    """Bytes of the dispatched operators (inputs and outputs, unfused) and
    the live bytes of every storage they create, with its peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        """Count the storage of ``t`` as live until it is freed."""
        st = t.untyped_storage()
        try:
            if st in self._seen:
                return
        except TypeError:  # a storage that takes no weak reference
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def reset(self) -> None:
        """Count from here: no bytes yet, the peak at what is live."""
        self.bytes, self.ops, self.peak = 0, 0, self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns not in ("c10d", "prim") and name not in _SKIPPED and not func.is_view:
            ins = list(_leaves((args, kwargs)))
            if not name.startswith("empty") and not name.startswith("new_empty"):
                self.bytes += sum(_nbytes(t) for t in ins)
                self.bytes += sum(_nbytes(t) for t in _leaves(out))
                self.ops += 1
        for t in _leaves(out):
            self.track(t)
        return out


@contextlib.contextmanager
def _small_constants(limit: int = 64):
    """Keep tensors of up to ``limit`` elements built in the trace as
    constants (FakeTensorMode keeps only one-element ones), so the host
    reads of small parameters (the Matérn orders, 1 / range) have values."""
    import torch._subclasses.fake_tensor as ft

    prev = ft.CONSTANT_NUMEL_LIMIT
    ft.CONSTANT_NUMEL_LIMIT = limit
    try:
        yield
    finally:
        ft.CONSTANT_NUMEL_LIMIT = prev


@contextlib.contextmanager
def _no_rejection_sampling():
    """``nn.init.trunc_normal_`` as a plain normal draw: recent PyTorch
    samples it by rejection, a loop on host reads of the draws, which a fake
    tensor does not have (the weights' values do not matter to a trace)."""
    init = torch.nn.init
    prev = init.trunc_normal_

    def draw(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
        with torch.no_grad():
            return tensor.normal_(mean, std, generator=generator)

    init.trunc_normal_ = draw
    try:
        yield
    finally:
        init.trunc_normal_ = prev


@contextlib.contextmanager
def fake_world(world: int):
    """A "fake" process group of ``world`` ranks, this process rank 0:
    every collective returns at once, its buffers untouched."""
    import torch.distributed as dist

    # private module: the fake store of the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_type(device) -> str:
    if device is None:
        from ..device import resolve_device

        return resolve_device(None).type
    return torch.device(device).type


def trace(build, step, *, mesh, fake: bool = True) -> dict:
    """``build()`` (under the trace's tensor mode) gives ``(state, args)``;
    ``step(*args)`` runs once under the counters.  Returns the counts: FLOPs,
    bytes, collectives, the peak bytes (the live bytes after ``build``
    included, the build's own transients not) and the seconds.  With
    ``fake`` every tensor is a fake one; otherwise the step runs for real
    (the calibration against a real run).  The cyclic garbage collector is
    off meanwhile, but in a real run on the card (whose peak the allocator
    gives): the live bytes follow each storage's release, which a
    collection of a cycle would move from run to run."""
    if not fake and mesh is not None and mesh.device_type == "cuda":
        return _trace(build, step, mesh, fake)
    gc.collect()
    gc.disable()
    try:
        return _trace(build, step, mesh, fake)
    finally:
        gc.enable()


def _trace(build, step, mesh, fake: bool) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from .mesh import count_collectives

    t0 = time.perf_counter()
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    draws = _no_rejection_sampling() if fake else contextlib.nullcontext()
    cuda = not fake and mesh is not None and mesh.device_type == "cuda"
    # a real run on the card reads its peak from the allocator, and its
    # time without the counters' per-operator cost
    counters = Counters() if not cuda else contextlib.nullcontext(Counters())
    real = {}
    with _small_constants(), mode, counters as counters:
        with draws:
            state, args = build()
        counters.reset()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as flops, count_collectives(mesh) as coll:
            out = step(*args)
        del out
        if cuda:
            torch.cuda.synchronize()
            real = dict(
                step_s=time.perf_counter() - t1,
                device_peak_bytes=int(torch.cuda.max_memory_allocated()),
            )
    coll = {k: v for k, v in coll.items() if not k.startswith("_")}
    return dict(
        flops=float(flops.get_total_flops()),
        bytes=float(counters.bytes),
        ops=counters.ops,
        collectives=coll,
        peak_bytes=int(counters.peak),
        state=state,
        trace_s=time.perf_counter() - t0,
        **real,
    )


# ---------------------------------------------------------------------------
# Cell builders: (build, step, model FLOPs, compute dtype, notes)
# ---------------------------------------------------------------------------


def _state_bytes(tensors) -> int:
    return sum(_nbytes(t) for t in tensors)


def build_lm_cell(cfg, shape, mesh, attn_impl: str, microbatches: int = 1, *, device):
    """The LM cell's ``(build, step)``: the sharded model (and optimizer
    state, caches), this rank's inputs, and one train step, prefill (the
    last position's logits) or decode step (one token against a
    ``seq_len`` cache)."""
    from ..distribution import sharding as sh
    from ..models import decode_step, forward, init_caches, init_model
    from ..models import settings
    from ..models.shardspecs import batch_axes, dp_axes
    from ..training.optimizer import adamw_init
    from ..training.train_step import TrainConfig, train_step

    dp = dp_axes(mesh, shape.global_batch)
    if shape.kind == "train" and dp != batch_axes(mesh):
        # the gradients are summed over every DP axis (train_step)
        raise ValueError(
            f"{shape.name}: a training batch of {shape.global_batch} rows does "
            "not split over every data-parallel axis"
        )
    specs = cell_input_specs(cfg, shape)

    def inputs(gen):
        out = {}
        for k, spec in specs.items():
            if spec.dtype == torch.int32:
                t = torch.randint(
                    0, cfg.vocab_size, spec.shape, generator=gen, device=device,
                    dtype=torch.int32,
                )
            else:
                t = torch.randn(spec.shape, generator=gen, device=device).to(spec.dtype)
            out[k] = t
        with settings.fsdp_gather(mesh, dp):
            return sh.shard_batch(out, mesh, microbatches)

    def model_state():
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_model(cfg, generator=gen, device=device)
        if mesh is not None:
            sh.shard_params(model, cfg, mesh)
        return model, gen

    if shape.kind == "train":
        tcfg = TrainConfig(remat=True, attn_impl=attn_impl, microbatches=microbatches)

        def build():
            model, gen = model_state()
            opt = adamw_init(model)
            state = dict(
                param_bytes=_state_bytes(model.parameters()),
                opt_bytes=_state_bytes([*opt.master, *opt.m, *opt.v, opt.step]),
            )
            return state, (model, opt, inputs(gen))

        def step(model, opt, batch):
            return train_step(
                model, opt, None, batch, cfg=cfg, tcfg=tcfg, mesh=mesh,
                check_finite=False,
            )

        return build, step

    if shape.kind == "prefill":

        def build():
            model, gen = model_state()
            state = dict(param_bytes=_state_bytes(model.parameters()), opt_bytes=0)
            return state, (model, inputs(gen))

        def step(model, batch):
            with torch.no_grad(), settings.fsdp_gather(mesh, dp):
                out = forward(
                    model, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                    attn_impl=attn_impl,
                )
            return out.logits[:, -1]

        return build, step

    def build():
        model, gen = model_state()
        with settings.fsdp_gather(mesh, dp):
            caches = init_caches(
                cfg, shape.global_batch, shape.seq_len, device=device, mesh=mesh
            )
        state = dict(
            param_bytes=_state_bytes(model.parameters()),
            opt_bytes=0,
            cache_bytes=_state_bytes(_leaves(caches)),
        )
        return state, (model, caches, inputs(gen))

    def step(model, caches, batch):
        with torch.no_grad(), settings.fsdp_gather(mesh, dp):
            logits, _ = decode_step(
                model, cfg, caches, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), pos=shape.seq_len - 1, attn_impl=attn_impl,
            )
        return logits

    return build, step


def _geostat_params(device):
    from ..core.covariance import MaternParams

    # nu = (0.5, 2.5): every pair order {0.5, 1.5, 2.5} takes the closed
    # forms (the halfint instances on the card)
    return MaternParams.bivariate(
        a=0.09, nu11=0.5, nu22=2.5, beta=0.5, dtype=torch.float32, device=device
    )


def lowerable_inputs(specs, placements, *, device, generator=None, kmax=1):
    """Each input at its placement's local shape: locations uniform in the
    unit square, square tiles the identity plus a small symmetric draw
    (positive definite), other tiles small draws, ranks ``kmax``, the rest
    normal."""
    out = []
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    for spec, place in zip(specs, placements, strict=True):
        shp = place.local_shape(spec.shape)
        if spec.dtype == torch.int32:
            t = torch.full(shp, kmax, dtype=torch.int32, device=device)
        elif len(shp) == 2 and shp[1] == 2:
            t = torch.rand(shp, **kw)
        elif len(shp) >= 3 and shp[-1] == shp[-2]:
            d = 0.01 * torch.randn(shp, **kw) / shp[-1] ** 0.5
            t = torch.eye(shp[-1], device=device) + d @ d.mT
        elif len(shp) >= 3:
            t = 0.01 * torch.randn(shp, **kw)
        else:
            t = torch.randn(shp, **kw)
        out.append(t.to(spec.dtype))
    return out


def build_geostat_cell(cfg: GeoStatConfig, shape, mesh, *, device):
    """``(fn, specs, placements)`` of the geostatistics cell: cokriging
    (predict shapes), the exact loglik, or the TLR pipeline from locations
    (GEN -> compress -> factorize -> loglik).  The exact panel is
    max(tile_size, m / 64): the reference's max(4096, m / 64) at the
    production config's 4096."""
    from ..core.dist_cholesky import dist_cokrige_lowerable, dist_loglik_lowerable
    from ..core.dist_tlr import dist_tlr_pipeline_lowerable
    from ..distribution.sharding import Sharding

    params = _geostat_params(device)
    row = _row_axes(mesh)
    m = shape.matrix_dim
    rep = Sharding(mesh, ())
    if shape.kind == "predict":
        fn, specs = dist_cokrige_lowerable(
            shape.n_locations, shape.n_pred, shape.p, params,
            panel=max(cfg.tile_size, m // 64), mesh=mesh, row_axes=row,
        )
        return fn, specs, (rep,) * 3
    if cfg.backend == "exact":
        fn, specs = dist_loglik_lowerable(
            shape.n_locations, shape.p, params, panel=max(cfg.tile_size, m // 64),
            mesh=mesh, row_axes=row,
        )
        return fn, specs, (rep,) * 2
    fn, specs = dist_tlr_pipeline_lowerable(
        shape.n_locations, shape.p, params, tile_size=cfg.tile_size,
        max_rank=cfg.max_rank, tol=cfg.tol, nugget=1e-8, mesh=mesh, row_axes=row,
        super_panels=cfg.super_panels, block_cyclic=cfg.block_cyclic,
    )
    return fn, specs, (rep,) * 2


def _phase_counts(res: dict) -> dict:
    coll = res["collectives"]
    return dict(
        flops=res["flops"],
        bytes=res["bytes"],
        coll=float(sum(v["bytes"] for v in coll["by_axis"].values())),
        coll_s=rl.collective_seconds(coll["by_axis"]),
        coll_by_axis={k: v["bytes"] for k, v in coll["by_axis"].items()},
        temp_bytes=res["peak_bytes"],
        fits=res["peak_bytes"] <= rl.HBM_BYTES,
        trace_s=res["trace_s"],
    )


def tlr_phase_reports(cfg: GeoStatConfig, shape, mesh, *, device, fake=True) -> dict:
    """Each TLR pipeline phase traced alone: ``gen`` (the panels only),
    ``gen_compress`` (the replicated truncation batch) against
    ``gen_compress_sharded`` (each rank its own slots: the production form,
    aliased ``compress``) and ``gen_compress_mixed_f32``, the factorization
    from tiles as ``factorize_masked`` (the grid), ``factorize_bc`` (the
    pair slots, sharded recompress: the production form, aliased
    ``factorize``) and ``factorize_bc_repl`` (the whole layout on every
    rank), their tile inputs updated in place; and the serving phases from
    the registry, ``serve_fit`` and ``serve_predict`` (B = 512, with the
    roofline's ``predictions_per_sec``).  Each phase's ``temp_bytes`` is
    its peak live bytes a rank (inputs included).  ``compress_only`` is
    gen_compress less gen; ``pair_stats``, ``recompress_temp_model`` and
    ``compress_temp_model`` are the closed-form models of
    ``launch.roofline``."""
    from ..core.dist_tlr import (
        dist_tlr_compress_lowerable,
        dist_tlr_gen_lowerable,
        dist_tlr_in_shardings,
        dist_tlr_lowerable,
    )
    from ..distribution.block_cyclic import pair_shards
    from ..distribution.sharding import Sharding
    from ..lowerables import build as build_lowerables

    row = _row_axes(mesh)
    m = shape.matrix_dim
    nb, kmax = cfg.tile_size, cfg.max_rank
    t_tiles = m // nb
    rep = (Sharding(mesh, ()),)
    kw = dict(tile_size=nb, mesh=mesh, row_axes=row)
    ckw = dict(kw, max_rank=kmax, tol=cfg.tol, nugget=1e-8, block_cyclic=cfg.block_cyclic)

    def params():
        return _geostat_params(device)

    cells = {
        "gen": lambda: (
            *dist_tlr_gen_lowerable(shape.n_locations, shape.p, params(), **kw), rep),
        "gen_compress": lambda: (*dist_tlr_compress_lowerable(
            shape.n_locations, shape.p, params(), shard_svd=False, **ckw), rep),
        "gen_compress_sharded": lambda: (*dist_tlr_compress_lowerable(
            shape.n_locations, shape.p, params(), shard_svd=True, **ckw), rep),
        "gen_compress_mixed_f32": lambda: (*dist_tlr_compress_lowerable(
            shape.n_locations, shape.p, params(), shard_svd=True,
            dtype_policy="mixed_f32", **ckw), rep),
    }
    for name, bc, shard_qr in (
        ("factorize_masked", False, True),
        ("factorize_bc", True, True),
        ("factorize_bc_repl", True, False),
    ):
        def fac(bc=bc, shard_qr=shard_qr):
            fn, specs = dist_tlr_lowerable(
                t_tiles, nb, kmax, tol=cfg.tol, mesh=mesh, row_axes=row,
                super_panels=cfg.super_panels, block_cyclic=bc, return_factor=True,
                shard_recompress=shard_qr,
            )
            return fn, specs, dist_tlr_in_shardings(
                mesh=mesh, row_axes=row, block_cyclic=bc)

        cells[name] = fac

    def serve(name):  # from the registry: one registration, every consumer
        low = build_lowerables("cokrige_serving", shape, mesh)[name]
        return low.fn, low.specs, low.in_shardings

    for name in ("serve_fit", "serve_predict"):
        cells[name] = lambda n=name: serve(n)
    out = {}
    for name, make in cells.items():
        res = trace(*_lowerable_pair(make, device), mesh=mesh, fake=fake)
        out[name] = _phase_counts(res)
    out["compress_only"] = {
        k: max(out["gen_compress"][k] - out["gen"][k], 0.0)
        for k in ("flops", "bytes", "coll")
    }
    out["factorize"] = out["factorize_bc" if cfg.block_cyclic else "factorize_masked"]
    out["compress"] = out["gen_compress_sharded"]
    shards = pair_shards(mesh, row)
    out["pair_stats"] = rl.tlr_pair_update_stats(t_tiles, cfg.super_panels, shards)
    out["recompress_temp_model"] = rl.tlr_recompress_temp_model(
        t_tiles, nb, kmax, shards
    )
    out["compress_temp_model"] = rl.tlr_compress_temp_model(
        t_tiles, nb, kmax, n_shards=shards
    )
    sp = out["serve_predict"]
    sp["predictions_per_sec"] = rl.serve_predictions_per_sec(
        sp["flops"], sp["bytes"], sp["coll_s"], batch=512
    )
    return out


def _lowerable_pair(make, device):
    """``(build, step)`` from ``make() -> (fn, specs, placements)``, the
    constructor called inside the trace (its parameters are fake too): the
    inputs at their placements' local shapes, then ``fn``."""
    holder = {}

    def build():
        fn, specs, placements = make()
        holder["fn"] = fn
        kmax = max((s.shape[-1] for s in specs if len(s.shape) == 3), default=1)
        gen = torch.Generator(device=device).manual_seed(0)
        args = lowerable_inputs(
            specs, placements, device=device, generator=gen, kmax=kmax
        )
        return dict(param_bytes=0, opt_bytes=0, input_bytes=_state_bytes(args)), args

    def step(*args):
        return holder["fn"](*args)

    return build, step


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _real_world(world: int, device_type: str):
    """A real process group of one rank (gloo on the CPU, NCCL on the
    card) over a file store: the calibration's real run."""
    import tempfile

    import torch.distributed as dist

    if world != 1:
        raise ValueError(f"a real run of one process has one rank, not {world}")
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1,
        )
        try:
            yield
        finally:
            dist.destroy_process_group()


def trace_cell(cfg, shape, mesh, *, device, fake=True, attn_impl="naive",
               microbatches=1, phases=True):
    """One cell's counts on this rank of ``mesh`` (an existing process
    group: the fake one of ``run_cell``, or real ranks, whose run is then
    real with ``fake=False``): ``(trace counts, TLR phases or None, model
    FLOPs, compute dtype, notes)``."""
    dev = torch.device(device)
    notes, reports = [], None
    if isinstance(cfg, GeoStatConfig):
        mf = rl.geostat_model_flops(shape, cfg.backend, cfg.tile_size, cfg.max_rank)

        def make():
            return build_geostat_cell(cfg, shape, mesh, device=dev)

        res = trace(*_lowerable_pair(make, dev), mesh=mesh, fake=fake)
        if phases and cfg.backend == "tlr" and shape.kind != "predict":
            reports = tlr_phase_reports(cfg, shape, mesh, device=dev, fake=fake)
        return res, reports, mf, "float32", notes
    from ..models import settings

    build, step = build_lm_cell(cfg, shape, mesh, attn_impl, microbatches, device=dev)
    with settings.moe_at_capacity():
        res = trace(build, step, mesh=mesh, fake=fake)
    if cfg.moe:
        notes.append("MoE dispatch at capacity (static shapes)")
    return res, reports, rl.lm_model_flops(cfg, shape), cfg.dtype, notes


def run_lowerable(name: str, shape, *, device=None, fake=True, world=(1, 1),
                  cell=None) -> dict:
    """Trace (or, with ``fake=False``, run) the registered lowerable
    ``name`` (cell ``cell``, default the target's only one) at ``shape`` on
    rank 0 of a mesh of ``world``: its counts, the roofline terms of its
    float32 work (``roofline``) and the peak."""
    from ..lowerables import build
    from .mesh import axes_for, make_mesh

    dev_type = _device_type(device)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    chips = 1
    for n in world:
        chips *= n
    with fake_world(chips) if fake else _real_world(chips, dev_type):
        mesh = make_mesh(tuple(world), axes_for(tuple(world)), device_type=dev_type)

        def make():
            low = build(name, shape, mesh)[cell or name]
            return low.fn, low.specs, low.in_shardings

        res = trace(*_lowerable_pair(make, dev), mesh=mesh, fake=fake)
    report = rl.analyze(name, shape.name, "x".join(map(str, world)), chips, res,
                        0.0, compute_dtype="float32")
    out = dict(res)
    out.update(compute_s=report.compute_s, memory_s=report.memory_s,
               collective_s=report.collective_s, dominant=report.dominant,
               roofline_s=max(report.compute_s, report.memory_s, report.collective_s))
    return out


def run_cell(
    arch_name: str,
    shape_name: str,
    mesh_name: str,
    attn_impl: str = "naive",
    out_dir: str = RESULTS_DIR,
    variant: str = "baseline",
    correct_costs: bool = True,
    cfg_overrides: dict | None = None,
    microbatches: int = 1,
    *,
    device=None,
    world=None,
    cfg=None,
    shape=None,
    fake=True,
) -> dict:
    """Trace one cell on rank 0 of the fake production mesh ``mesh_name``
    ("pod" or "multipod") and write its record to ``out_dir`` (None: no
    file).  ``device`` defaults to the card and raises without one; pass
    "cpu" to trace CPU tensors.  ``correct_costs=False`` skips a TLR
    cell's phase reports (``--no-correct``).  ``world`` (a mesh shape)
    replaces the production mesh, ``cfg`` and ``shape`` the registered
    config and shape (tests at reduced sizes).  ``fake=False`` (a ``world``
    of one rank) runs the cell for real on a process group of one: the
    calibration of the trace against a real run."""
    from .mesh import axes_for, make_mesh

    dev = torch.device(_device_type(device), 0) if _device_type(device) == "cuda" \
        else torch.device("cpu")
    cfg = get_arch(arch_name) if cfg is None else cfg
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(cfg, shape_name) if shape is None else shape
    mshape = tuple(world) if world is not None else MESHES[mesh_name]
    chips = 1
    for n in mshape:
        chips *= n
    world = fake_world(chips) if fake else _real_world(chips, dev.type)
    with world:
        mesh = make_mesh(mshape, axes_for(mshape), device_type=dev.type)
        res, phases, mf, dtype, notes = trace_cell(
            cfg, shape, mesh, device=dev, fake=fake, attn_impl=attn_impl,
            microbatches=microbatches, phases=correct_costs,
        )
    report = rl.analyze(
        arch_name, shape_name, mesh_name, chips,
        res, mf, compute_dtype=dtype,
    )
    state = res["state"]
    peak = res["peak_bytes"]
    rec = report.to_dict()
    rec.update(
        status="ok",
        variant=variant,
        attn_impl=attn_impl,
        device=dev.type,
        mesh_shape=list(mshape),
        peak_bytes=peak,
        param_bytes=state.get("param_bytes", 0),
        opt_bytes=state.get("opt_bytes", 0),
        other_bytes=peak - state.get("param_bytes", 0) - state.get("opt_bytes", 0),
        cache_bytes=state.get("cache_bytes", 0),
        fits=peak <= rl.HBM_BYTES,
        hbm_bytes=rl.HBM_BYTES,
        collectives=res["collectives"],
        dispatched_ops=res["ops"],
        trace_s=res["trace_s"],
        fake=fake,
        step_s=res.get("step_s"),
        device_peak_bytes=res.get("device_peak_bytes"),
        cost_correction=COST_CORRECTION,
        bytes_counted="each dispatched operator's tensor inputs and outputs, unfused",
        card=rl.CARD,
        notes=notes,
    )
    if phases is not None:
        rec["tlr_phases"] = phases
        for name in ("gen", "gen_compress", "gen_compress_sharded",
                     "gen_compress_mixed_f32", "factorize_masked", "factorize_bc",
                     "factorize_bc_repl", "serve_fit", "serve_predict"):
            ph = phases[name]
            print(f"tlr_phase {name:24s} flops={ph['flops']:.4g} "
                  f"bytes={ph['bytes']:.4g} coll={ph['coll']:.4g} "
                  f"temp={ph['temp_bytes']:.4g} trace_s={ph['trace_s']:.1f}")
        print(f"tlr_serving predictions_per_sec="
              f"{phases['serve_predict']['predictions_per_sec']:.4g} (B=512 roofline)")
    print(f"== {arch_name} x {shape_name} x {mesh_name} [{variant}] ==")
    print(f"peak={peak / 1e9:.3f} GB fits={rec['fits']} flops={res['flops']:.4g} "
          f"bytes={res['bytes']:.4g} coll={rec['collective_bytes_per_chip']:.4g} "
          f"trace_s={res['trace_s']:.1f}")
    print(rl.format_report_row(report))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch_name}__{shape_name}__{mesh_name}__{variant}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--attn-impl", default="naive", choices=["naive", "chunked", "kernel"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tlr-super-panels", type=int, default=0,
                    help="override GeoStatConfig.super_panels for TLR cells")
    ap.add_argument("--tlr-block-cyclic", type=int, default=-1, choices=[-1, 0, 1],
                    help="override GeoStatConfig.block_cyclic for TLR cells "
                         "(0: the grid form, 1: pair-major)")
    ap.add_argument("--no-correct", action="store_true",
                    help="skip the TLR cells' phase reports")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="the device of the fake tensors (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, ok in iter_cells():
            print(f"{arch.name:28s} {shape.name:12s} "
                  f"{'run' if ok else 'SKIP (full attention @500k)'}")
        return
    _device_type(args.device)  # on the card unless the CPU is named
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a.name, s.name) for a, s, ok in iter_cells() if ok]
    else:
        cells = [(args.arch, args.shape)]
    failures = []
    for arch_name, shape_name in cells:
        for mesh_name in meshes:
            fname = os.path.join(
                args.out_dir, f"{arch_name}__{shape_name}__{mesh_name}__{args.variant}.json"
            )
            if args.skip_existing and os.path.exists(fname):
                print(f"skip existing {fname}")
                continue
            overrides = {}
            if arch_name == "geostat-tlr":
                if args.tlr_super_panels:
                    overrides["super_panels"] = args.tlr_super_panels
                if args.tlr_block_cyclic >= 0:
                    overrides["block_cyclic"] = bool(args.tlr_block_cyclic)
            try:
                run_cell(
                    arch_name, shape_name, mesh_name, args.attn_impl, args.out_dir,
                    args.variant, correct_costs=not args.no_correct,
                    cfg_overrides=overrides or None, microbatches=args.microbatches,
                    device=args.device,
                )
            except Exception as e:  # recorded and the run goes on
                traceback.print_exc()
                failures.append((arch_name, shape_name, mesh_name, repr(e)[:300]))
                os.makedirs(args.out_dir, exist_ok=True)
                with open(fname, "w") as f:
                    json.dump(dict(arch=arch_name, shape=shape_name, mesh=mesh_name,
                                   variant=args.variant, status="failed",
                                   error=repr(e)[:2000]), f, indent=1)
            sys.stdout.flush()
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("dry-run complete: every cell traced")


if __name__ == "__main__":
    main()

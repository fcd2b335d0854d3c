"""Device meshes, rank processes and the collectives of the multi-device forms.

Counterpart of ``repro.launch.mesh``, and the port's model of execution for
every ``mesh=`` argument of the geostatistics path:

  * **Ranks.**  One process a rank, SPMD.  The mesh is a
    ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
    ``("data", "model")``, or ``("pod", "data", "model")`` across pods, as
    the reference's meshes are.  Every rank calls
    the same entry point with the same replicated arguments (locations,
    data, parameters), as the reference's single controller does; scalars
    and vectors (a loglik, a ``FactorStatus``, a prediction) come back whole
    on every rank.  Each module says where a factor may come back as the
    rank's own share.
  * **Collectives.**  Only ``broadcast``, ``all_reduce`` and ``all_gather``,
    on the mesh's process group (``broadcast_``, ``all_reduce_`` and
    ``all_gather`` below).  NCCL is the backend when each rank has its own
    GPU, gloo on the CPU.  Several ranks on one GPU cannot use NCCL (it
    refuses two ranks on one device); there gloo carries the CUDA tensors
    as a stand-in transport, named so by the caller (``spawn_ranks(...,
    backend="gloo", device_type="cuda")``), never picked silently.  gloo
    takes CUDA tensors in each of the three collectives
    (``scripts/mesh_transport.py`` checks them on the card), so none is
    staged through the host.  A reduce-scatter is an ``all_reduce`` and a
    slice.  ``axis_group`` gives the process group of one mesh axis or of
    several; the sharded LM's collectives run on those groups, through the
    autograd Functions below (``copy_to_region``, ``reduce_from_region``,
    ``gather_dim``).
  * **Launcher.**  ``spawn_ranks`` is the counterpart of the reference's
    fake-CPU-device subprocesses: it starts W rank processes (``spawn``, a
    ``FileStore`` in a temporary directory, one torch thread a rank), builds
    the mesh in each, runs a module-level function there and returns each
    rank's result, raising as soon as a rank fails.  The process group has a
    ``timeout``, so a rank stuck in a collective fails instead of hanging.
    On several GPUs the same functions run under
    ``torchrun --nproc-per-node W`` after ``init_process_group``.  The
    meshes are built on the card unless the caller names
    ``device_type="cpu"``; without CUDA the default raises, as
    ``device.resolve_device`` does.

Every branch on data that a multi-device form takes on the host is decided
on a reduced value (summed counts, the min of pivots), so all ranks take it
the same way and none waits in a collective that the others skip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import queue
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

__all__ = [
    "AXES",
    "POD_AXES",
    "make_mesh",
    "make_mesh_for_devices",
    "make_production_mesh",
    "mesh_chip_count",
    "mesh_shape_for",
    "spawn_ranks",
    "to_host",
    "broadcast_",
    "all_reduce_",
    "all_gather",
    "all_gather_rows",
    "group_sum",
    "axis_group",
    "axis_size",
    "axis_index",
    "copy_to_region",
    "reduce_from_region",
    "gather_dim",
]

AXES = ("data", "model")
POD_AXES = ("pod",) + AXES
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group first "
            "(spawn_ranks does, and torchrun sets up its environment)"
        )
    return dist


def mesh_shape_for(n: int, model_parallel: int = 0) -> tuple[int, int]:
    """The reference's (data, model) shape rule for ``n`` devices: model is
    the largest power of two whose square is at most n, unless given."""
    if model_parallel <= 0:
        model_parallel = 1
        while (model_parallel * 2) ** 2 <= n:
            model_parallel *= 2
        model_parallel = min(model_parallel, n)
    return max(n // model_parallel, 1), model_parallel


def axes_for(shape) -> tuple:
    """The axis names of a mesh of ``shape``: ``POD_AXES`` for three dims,
    else ``AXES``."""
    return POD_AXES if len(shape) == 3 else AXES


def _device_type(device_type) -> str:
    """``device_type`` if named, else "cuda"; CUDA without a CUDA device
    raises, so the CPU runs only when named."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh's ranks run on CUDA devices by default and no CUDA device "
            "is available; pass device_type='cpu' to build a CPU mesh"
        )
    return device_type


def make_mesh(shape, names, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the process
    group's ranks (their product must be the world size).  Every rank must
    build the same meshes in the same order: each builds its groups."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(n) for n in shape), tuple(names)
    world, need = _dist().get_world_size(), math.prod(shape)
    if world != need or len(shape) != len(names):
        raise ValueError(
            f"a mesh {shape} over {names} needs {need} ranks, the group has {world}"
        )
    mesh = init_device_mesh(_device_type(device_type), shape, mesh_dim_names=names)
    mesh_grid(mesh)
    return mesh


def make_mesh_for_devices(
    n_devices: int | None = None, model_parallel: int = 0, *, device_type=None
):
    """A ("data", "model") ``DeviceMesh`` over the process group's ranks,
    shaped by the reference's rule (``mesh_shape_for``); ``n_devices`` must
    be the world size when given.  On the card unless ``device_type``
    names another."""
    device_type = _device_type(device_type)
    world = _dist().get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    shape = mesh_shape_for(n, model_parallel)
    if shape[0] * shape[1] != n:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} ranks")
    return make_mesh(shape, AXES, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes: (16, 16) ("data", "model") over
    256 ranks, or (2, 16, 16) ("pod", "data", "model") over 512.  The world
    size must match.  On the card unless ``device_type`` names another."""
    device_type = _device_type(device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = POD_AXES if multi_pod else AXES
    world, need = _dist().get_world_size(), int(np.prod(shape))
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, not {world}")
    return make_mesh(shape, names, device_type=device_type)


def mesh_grid(mesh) -> np.ndarray:
    """The mesh's global ranks as a numpy array of its shape (cached on the
    mesh).  The host bookkeeping of the mesh forms reads it, never the
    mesh's rank tensor, so it also runs inside a trace of fake tensors."""
    grid = mesh.__dict__.get("_repro_grid")
    if grid is None:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            grid = np.asarray(mesh.mesh.tolist())
        mesh.__dict__["_repro_grid"] = grid
    return grid


def mesh_chip_count(mesh) -> int:
    """Ranks in the mesh (one a device in production)."""
    return int(mesh_grid(mesh).size)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


# The wall seconds of this module's collectives by kind while
# ``time_collectives`` is on, else None.
_CLOCK: dict | None = None
# The bytes of this module's collectives while ``count_collectives`` is on
# (by kind, and by the mesh axes each group spans), else None.
_COUNTS: dict | None = None


@contextlib.contextmanager
def time_collectives():
    """Within it, each ``broadcast_``, ``all_reduce_`` and ``all_gather``
    adds its wall seconds to the dict it yields, under its kind
    ("broadcast", "all_reduce", "all_gather"), whoever calls it.  On a CUDA
    tensor each call then synchronizes the device before and after, so the
    time is the collective's own, and the work around it loses the overlap
    it would have had."""
    global _CLOCK
    _CLOCK = {}
    try:
        yield _CLOCK
    finally:
        _CLOCK = None


@contextlib.contextmanager
def count_collectives(mesh=None):
    """Within it, each ``broadcast_``, ``all_reduce_`` and ``all_gather``
    adds the bytes of its operand (the tensor a rank sends: the reference's
    HLO operand sizes) to the dict it yields: ``by_kind`` (kind -> bytes,
    ``counts`` kind -> calls) and ``by_axis``, keyed by the axes of
    ``mesh`` along which the group's ranks differ ("data", "model",
    "data+model", ...), each ``{"bytes", "calls", "ranks", "link_bw"}``
    with the group's size and the per-GPU rate of the link it spans
    (``roofline.link_bw``).  Without a mesh the key is "world".  Works on
    fake tensors (a fake process group), since it reads only shapes."""
    global _COUNTS
    _COUNTS = dict(by_kind={}, counts={}, by_axis={}, mesh=mesh, _groups={})
    try:
        yield _COUNTS
    finally:
        _COUNTS.pop("_groups", None)
        _COUNTS.pop("mesh", None)
        _COUNTS = None


def _group_axes(group) -> tuple[str, tuple]:
    """(axis key, global ranks) of a process group in the counted mesh."""
    dist = _dist()
    cache = _COUNTS["_groups"]
    key = id(group)
    if key not in cache:
        if group is None or group is dist.group.WORLD:
            ranks = tuple(range(dist.get_world_size()))
        else:
            ranks = tuple(dist.get_process_group_ranks(group))
        mesh = _COUNTS["mesh"]
        name = "world"
        if mesh is not None:
            grid = mesh_grid(mesh)
            coords = np.array([np.argwhere(grid == r)[0] for r in ranks])
            names = tuple(mesh.mesh_dim_names)
            varied = [names[d] for d in range(len(names)) if len(set(coords[:, d])) > 1]
            name = "+".join(varied) or "none"
        cache[key] = (name, ranks)
    return cache[key]


def _counted(kind: str, t: torch.Tensor, group) -> None:
    from .roofline import link_bw

    nbytes = t.numel() * t.element_size()
    _COUNTS["by_kind"][kind] = _COUNTS["by_kind"].get(kind, 0) + nbytes
    _COUNTS["counts"][kind] = _COUNTS["counts"].get(kind, 0) + 1
    name, ranks = _group_axes(group)
    rec = _COUNTS["by_axis"].setdefault(
        name, dict(bytes=0, calls=0, ranks=len(ranks), link_bw=link_bw(ranks))
    )
    rec["bytes"] += nbytes
    rec["calls"] += 1


def _clocked(kind: str, t: torch.Tensor, run, group=None):
    """``run()``, timed into ``_CLOCK[kind]`` while ``time_collectives`` is
    on, its bytes counted while ``count_collectives`` is."""
    if _COUNTS is not None:
        _counted(kind, t, group)
    if _CLOCK is None:
        return run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    _CLOCK[kind] = _CLOCK.get(kind, 0.0) + time.perf_counter() - t0
    return out


def _in_place(t: torch.Tensor, run) -> torch.Tensor:
    """Run the collective ``run`` on ``t`` in place, through a contiguous
    copy where ``t`` is not contiguous: gloo would send a column-major
    tensor (a LAPACK factor) in its storage order."""
    if t.is_contiguous():
        run(t)
        return t
    buf = t.contiguous()
    run(buf)
    return t.copy_(buf)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Broadcast ``t`` from global rank ``src`` to the group, in place."""
    dist = _dist()

    def run(x):
        dist.broadcast(x, src, group=group)

    return _clocked("broadcast", t, lambda: _in_place(t, run), group)


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``t`` over the group, in place."""
    dist = _dist()
    rop = getattr(dist.ReduceOp, op.upper())

    def run(x):
        dist.all_reduce(x, op=rop, group=group)

    return _clocked("all_reduce", t, lambda: _in_place(t, run), group)


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in place, ``t`` itself for None (an
    ``axis_group`` of one rank; never the whole process group)."""
    return t if group is None else all_reduce_(t, group=group)


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group rank order."""
    dist = _dist()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _clocked("all_gather", t, lambda: dist.all_gather(parts, t, group=group), group)
    return parts


def all_gather_rows(t: torch.Tensor, rows: int, group=None) -> torch.Tensor:
    """Every rank's ``t``, whose leading size may differ from rank to rank,
    zero-padded to ``rows`` (at least the largest) and stacked:
    (ranks, rows, ...) in group rank order."""
    buf = t.new_zeros((rows,) + tuple(t.shape[1:]))
    buf[: t.shape[0]] = t
    return torch.stack(all_gather(buf, group))


def _axes(mesh, axes) -> tuple:
    """``axes`` (a name or names) as the mesh's axes of more than one rank,
    in the mesh's dim order; raises for a name that is not a mesh axis."""
    names = tuple(mesh.mesh_dim_names)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in names]
    if unknown:
        raise ValueError(f"axes {unknown} are not axes of the mesh {names}")
    return tuple(a for a in names if a in axes and mesh.size(names.index(a)) > 1)


def axis_group(mesh, axes):
    """The process group of the mesh axes ``axes`` (a name or a tuple of
    names) through this rank: the ranks whose coordinates differ from its
    own only along them, in group rank order the coordinate flattened over
    the axes in the mesh's dim order.  None where the axes span one rank
    (the collectives below then do nothing).

    One axis is the mesh's own group; several are built here once a mesh,
    on every rank in the same order (each rank creates every group), so a
    rank body must ask for them at the same point on every rank.  None
    without a mesh."""
    if mesh is None:
        return None
    live = _axes(mesh, axes)
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if live not in cache:
        if not live:
            cache[live] = None
        elif len(live) == 1:
            cache[live] = mesh.get_group(live[0])
        else:
            dist = _dist()
            names = tuple(mesh.mesh_dim_names)
            dims = [names.index(a) for a in live]
            rest = [d for d in range(len(names)) if d not in dims]
            size = math.prod(mesh.size(d) for d in dims)
            grid = mesh_grid(mesh).transpose(*rest, *dims)
            me, mine = dist.get_rank(), None
            for row in grid.reshape(-1, size).tolist():
                group = dist.new_group(ranks=row)
                if me in row:
                    mine = group
            cache[live] = mine
    return cache[live]


def axis_size(mesh, axes) -> int:
    """Ranks along the mesh axes ``axes`` (1 without a mesh)."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in _axes(mesh, axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes``, flattened as ``axis_group``
    orders its ranks (0 without a mesh)."""
    group = None if mesh is None else axis_group(mesh, axes)
    return 0 if group is None else _dist().get_rank(group)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), group=ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        ctx.size = x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = all_reduce_(grad.contiguous().clone(), group=ctx.group)
        start = _dist().get_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None, None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a model-parallel region: ``x`` as it is, and in the backward
    pass its gradient summed over ``group`` (each rank's part of the region
    gives a part of it)."""
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a model-parallel region: the sum of ``x`` over ``group``, and
    in the backward pass the gradient as it is (every rank holds the whole
    of it).  Not ``torch.distributed.nn``'s all_reduce, whose backward sums
    again and would scale the gradient by the group's size."""
    return x if group is None else _ReduceFromRegion.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group, reduce_grad: bool = True):
    """Every rank's ``x`` of ``group`` joined along ``dim`` in group rank
    order (an ``all_gather``).  In the backward pass the rank keeps its own
    slice of the gradient, summed over ``group`` first where
    ``reduce_grad`` (a reduce-scatter: the ranks' gradients are parts, as
    over a data axis) and taken as it is otherwise (every rank computed
    the same whole gradient)."""
    return x if group is None else _GatherDim.apply(x, dim, group, reduce_grad)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def to_host(obj):
    """``obj`` with every tensor in it as a numpy array, through dicts, lists
    and tuples (a named tuple comes back a plain tuple), for passing between
    processes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_host(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_host(v) for v in obj)
    return obj


# The BLAS and OpenMP pools of a rank (numpy's among them, created before
# the rank body runs), sized to the one torch thread a rank takes: W ranks
# with a pool of one thread a core each would contend for the cores.  A
# rank inherits the environment at its start, so the variables are set
# around the starts, under a lock: spawns from two threads must not
# restore each other's values.
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def _one_thread_env():
    with _ENV_LOCK:
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update({k: "1" for k in _ONE_THREAD})
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


@dataclasses.dataclass(frozen=True)
class _RankSpec:
    world: int
    store: str
    backend: str
    device_type: str
    timeout_s: float
    mesh_shape: tuple | None


def _rank_main(rank: int, spec: _RankSpec, fn, args, results) -> None:
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        if spec.device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            spec.backend,
            store=dist.FileStore(spec.store, spec.world),
            rank=rank,
            world_size=spec.world,
            timeout=datetime.timedelta(seconds=spec.timeout_s),
        )
        if spec.mesh_shape is None:
            mesh = make_mesh_for_devices(spec.world, device_type=spec.device_type)
        else:
            mesh = make_mesh(
                spec.mesh_shape, axes_for(spec.mesh_shape), device_type=spec.device_type
            )
        out = to_host(fn(mesh, *args))
        results.put(("ok", rank, out))
    except Exception:  # reported to the parent, which raises
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    fn,
    world: int,
    *,
    args: tuple = (),
    backend: str = "gloo",
    device_type: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    mesh_shape: tuple | None = None,
) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new rank processes and return
    their results, in rank order (tensors as numpy arrays, ``to_host``).

    ``fn`` must be a module-level function of a module that the ranks can
    import without JAX.  Each rank sets one torch thread, its device
    (``device_type="cuda"``: rank % device_count), a process group of
    ``backend`` over a ``FileStore`` in a temporary directory (no TCP port)
    with ``timeout_s``, and a ("data", "model") mesh of
    ``mesh_shape_for(world)``, or of ``mesh_shape``: over ``AXES`` for two
    dims, over ``POD_AXES`` for three, e.g. (2, 1, 2) over ("pod", "data",
    "model"); a rank body may build further meshes
    over the same ranks (``make_mesh``).  ``device_type`` defaults to
    "cuda" and raises without a CUDA device: the CPU runs only when named.
    With ``device_type="cuda"`` the kernel library is built here first, so
    the ranks load it instead of compiling it each.  Raises
    ``RuntimeError`` with the rank's traceback as soon as a rank fails or
    dies, after stopping the others; also after ``timeout_s`` plus a minute
    without every result.
    """
    import multiprocessing as mp

    device_type = _device_type(device_type)
    if mesh_shape is not None:
        mesh_shape = tuple(int(n) for n in mesh_shape)
        if len(mesh_shape) not in (2, 3) or math.prod(mesh_shape) != world:
            raise ValueError(
                f"mesh_shape {mesh_shape} is not two or three dims of {world} ranks"
            )
    if device_type == "cuda":
        from ..kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        spec = _RankSpec(
            world, os.path.join(tmp, "store"), backend, device_type, timeout_s,
            mesh_shape,
        )
        procs = [
            ctx.Process(
                target=_rank_main, args=(r, spec, fn, args, results), daemon=True
            )
            for r in range(world)
        ]
        with _one_thread_env():
            for p in procs:
                p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while len(out) < world:
                try:
                    kind, rank, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [
                        r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)
                    ]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}"
                        ) from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"ranks timed out after {timeout_s} s"
                        ) from None
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world)]

"""Device meshes, rank processes and the collectives of the multi-device forms.

Counterpart of ``repro.launch.mesh``, and the port's model of execution for
every ``mesh=`` argument of the geostatistics path:

  * **Ranks.**  One process a rank, SPMD.  The mesh is a
    ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
    ``("data", "model")``, as the reference's meshes are.  Every rank calls
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
    staged through the host.
  * **Launcher.**  ``spawn_ranks`` is the counterpart of the reference's
    fake-CPU-device subprocesses: it starts W rank processes (``spawn``, a
    ``FileStore`` in a temporary directory, one torch thread a rank), builds
    the mesh in each, runs a module-level function there and returns each
    rank's result, raising as soon as a rank fails.  The process group has a
    ``timeout``, so a rank stuck in a collective fails instead of hanging.
    On several GPUs the same functions run under
    ``torchrun --nproc-per-node W`` after ``init_process_group``.

Every branch on data that a multi-device form takes on the host is decided
on a reduced value (summed counts, the min of pivots), so all ranks take it
the same way and none waits in a collective that the others skip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
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
]

AXES = ("data", "model")
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


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh_for_devices(
    n_devices: int | None = None, model_parallel: int = 0, *, device_type=None
):
    """A ("data", "model") ``DeviceMesh`` over the process group's ranks,
    shaped by the reference's rule (``mesh_shape_for``); ``n_devices`` must
    be the world size when given."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _dist().get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    shape = mesh_shape_for(n, model_parallel)
    if shape[0] * shape[1] != n:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} ranks")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes: (16, 16) ("data", "model") over
    256 ranks, or (2, 16, 16) ("pod", "data", "model") over 512.  The world
    size must match.  The geostatistics forms refuse a "pod" axis that their
    ``row_axes`` leave out (``distribution.block_cyclic.pair_shard``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod",) + AXES if multi_pod else AXES
    world, need = _dist().get_world_size(), int(np.prod(shape))
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, not {world}")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=names)


def mesh_chip_count(mesh) -> int:
    """Ranks in the mesh (one a device in production)."""
    return int(mesh.mesh.numel())


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


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

    return _in_place(t, run)


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``t`` over the group, in place."""
    dist = _dist()
    rop = getattr(dist.ReduceOp, op.upper())

    def run(x):
        dist.all_reduce(x, op=rop, group=group)

    return _in_place(t, run)


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group rank order."""
    dist = _dist()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_rows(t: torch.Tensor, rows: int, group=None) -> torch.Tensor:
    """Every rank's ``t``, whose leading size may differ from rank to rank,
    zero-padded to ``rows`` (at least the largest) and stacked:
    (ranks, rows, ...) in group rank order."""
    buf = t.new_zeros((rows,) + tuple(t.shape[1:]))
    buf[: t.shape[0]] = t
    return torch.stack(all_gather(buf, group))


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
        mesh = make_mesh_for_devices(spec.world, device_type=spec.device_type)
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
    device_type: str = "cpu",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new rank processes and return
    their results, in rank order (tensors as numpy arrays, ``to_host``).

    ``fn`` must be a module-level function of a module that the ranks can
    import without JAX.  Each rank sets one torch thread, its device
    (``device_type="cuda"``: rank % device_count), a process group of
    ``backend`` over a ``FileStore`` in a temporary directory (no TCP port)
    with ``timeout_s``, and a ("data", "model") mesh of
    ``mesh_shape_for(world)``.  With ``device_type="cuda"``
    the kernel library is built here first, so the ranks load it instead of
    compiling it each.  Raises ``RuntimeError`` with the rank's traceback as
    soon as a rank fails or dies, after stopping the others; also after
    ``timeout_s`` plus a minute without every result.
    """
    import multiprocessing as mp

    if device_type == "cuda":
        from ..kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        spec = _RankSpec(
            world, os.path.join(tmp, "store"), backend, device_type, timeout_s
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

"""Fault-tolerant checkpointing: atomic npz payload + manifest, async save.

Counterpart of ``repro.checkpointing.checkpoint``, with its on-disk layout:
``<dir>/step_<N>/arrays.npz`` (keys ``a0..aN``) + ``manifest.json`` (step,
leaf names, dtypes, shapes, time, extra); ``<dir>/LATEST`` is a pointer
file flipped atomically *after* the payload is renamed and fsynced, so a
crash mid-write never corrupts the last good checkpoint (a restart reads
LATEST).  A payload is staged in a ``.tmp_ckpt_*`` directory that is
removed if the save fails.

Leaf names are the reference's (``jax.tree_util.keystr`` of each leaf's
path), so a checkpoint written by one package restores in the other:

* a NamedTuple's or dataclass's fields as ``.field``;
* a dict's entries as ``['key']``, in sorted key order (as JAX orders them);
* a list's or tuple's items as ``[i]``;
* ``None`` as no leaf;
* anything else (tensors, numpy arrays, Python scalars) as a leaf.

A torch tensor, unlike a JAX array, can change in place, and ``np.asarray``
of a CPU tensor shares its memory; so every save takes an owned host copy
of each leaf (detached from autograd) before it returns.  A bfloat16 leaf
is refused: numpy has no bfloat16, and the reference's own bf16 checkpoint
cannot be restored (ROADMAP Queue 3).

Elastic restore: ``restore_checkpoint(shardings=)`` places each leaf as a
tree of ``distribution.sharding.Sharding`` values says, this rank's shard
of it on its mesh, so a checkpoint restores onto another mesh shape or
from one device onto a mesh; without shardings every leaf comes back
whole (onto one device).  A checkpoint is written whole: on a mesh the
leaves are gathered first and one rank writes (``training.trainer``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

BF16_REFUSAL = (
    "a bfloat16 leaf cannot be checkpointed: numpy stores it as raw '|V2' "
    "bytes, which the reference cannot restore either (ROADMAP Queue 3, "
    "the reference's bf16 checkpoint fault)"
)


def _is_sharding(node) -> bool:
    from ..distribution.sharding import Sharding

    return isinstance(node, Sharding)


def _walk(node, path: str, names: list, leaves: list):
    """Append ``node``'s leaves and their names; return a function that
    rebuilds ``node``'s structure from an iterator of new leaves.  A
    ``Sharding`` is a leaf."""
    if node is None:
        return lambda it: None
    parts = None
    if _is_sharding(node):
        pass
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        keys, rebuild = list(node._fields), lambda vals: type(node)(*vals)
        parts = [(f".{k}", getattr(node, k)) for k in keys]
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        keys = [f.name for f in dataclasses.fields(node)]
        parts = [(f".{k}", getattr(node, k)) for k in keys]

        def rebuild(vals):
            return dataclasses.replace(node, **dict(zip(keys, vals)))

    elif isinstance(node, dict):
        try:
            keys = sorted(node)
        except TypeError as exc:
            raise ValueError(f"dict keys must be sortable: {list(node)}") from exc
        parts = [(f"[{k!r}]", node[k]) for k in keys]

        def rebuild(vals):
            return dict(zip(keys, vals))

    elif isinstance(node, (list, tuple)):
        parts = [(f"[{i}]", x) for i, x in enumerate(node)]
        kind = type(node)

        def rebuild(vals):
            return kind(vals)

    if parts is None:
        names.append(path)
        leaves.append(node)
        return lambda it: next(it)
    children = [_walk(child, path + key, names, leaves) for key, child in parts]
    return lambda it: rebuild([build(it) for build in children])


def _flatten_with_names(tree):
    """(names, leaves, unflatten): ``unflatten(new_leaves)`` rebuilds the
    tree's structure around new leaves, in the order of ``leaves``."""
    names, leaves = [], []
    build = _walk(tree, "", names, leaves)
    return names, leaves, lambda new: build(iter(new))


def _host_copy(leaf) -> np.ndarray:
    """An owned numpy copy of one leaf, taken now."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(BF16_REFUSAL)
        t = leaf.detach().resolve_conj().resolve_neg()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr
    arr = np.array(leaf, copy=True)
    if str(arr.dtype) == "bfloat16":
        raise ValueError(BF16_REFUSAL)
    return arr


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    # Directory fsync makes the rename itself durable (POSIX: a rename is
    # only on disk once the containing directory's metadata is).
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write(directory: str, step: int, names, host_leaves, extra, keep: int) -> str:
    """Write host arrays as checkpoint ``step`` (the reference's save)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(
            os.path.join(tmp, "arrays.npz"),
            **{f"a{i}": a for i, a in enumerate(host_leaves)},
        )
        manifest = dict(
            step=step,
            names=names,
            dtypes=[str(a.dtype) for a in host_leaves],
            shapes=[list(a.shape) for a in host_leaves],
            time=time.time(),
            extra=extra or {},
        )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(os.path.join(tmp, "arrays.npz"))
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # LATEST flips only after the payload's rename (crash-safe ordering).
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _fsync_dir(directory)
    _gc_old(directory, keep)
    return final


def save_checkpoint(
    directory: str, step: int, tree, extra: dict | None = None, keep: int = 3
) -> str:
    """Synchronous atomic save.  Returns the checkpoint path.

    Payload files and the staging directory are fsynced *before* the
    rename and the parent directory after it, so a power cut mid-save can
    lose the in-flight step but never corrupt an already-visible one.
    """
    names, leaves, _ = _flatten_with_names(tree)
    host = [_host_copy(x) for x in leaves]
    return _write(directory, step, names, host, extra, keep)


def _gc_old(directory: str, keep: int):
    # Tolerates concurrent deletion: a sibling process (or a previous GC)
    # removing a step between listdir and rmtree is not an error.
    try:
        steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    except FileNotFoundError:
        return
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Background saver: snapshot on the host, write off-thread.

    ``save`` blocks only for the host copy of every leaf (so changing a
    tensor in place after ``save`` returns does not change what is
    written); serialisation and fsync happen in a worker thread.
    ``wait()`` joins the outstanding write and raises its error, if any
    (call it before exit)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        names, leaves, _ = _flatten_with_names(tree)
        host = [_host_copy(x) for x in leaves]

        def work():
            try:
                _write(self.directory, step, names, host, extra, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class CheckpointManager:
    """Stateful wrapper over one checkpoint directory.

    Bundles ``save_checkpoint`` / ``restore_checkpoint`` / ``latest_step``
    with a fixed directory and retention policy: the handle the
    checkpointed multistart MLE (``core.optimize.multistart_nelder_mead``)
    threads around.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        return save_checkpoint(self.directory, step, tree, extra, self.keep)

    def restore(
        self, target_tree, step: int | None = None, shardings=None, *, device=None
    ):
        return restore_checkpoint(
            self.directory, target_tree, step, shardings, device=device
        )

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def all_steps(self) -> list[int]:
        try:
            return sorted(
                int(d.split("_")[1])
                for d in os.listdir(self.directory)
                if d.startswith("step_")
            )
        except FileNotFoundError:
            return []


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(
    directory: str, target_tree, step: int | None = None, shardings=None, *, device=None
):
    """Restore into the structure of ``target_tree``: ``(tree, manifest)``.

    The leaf names must equal the manifest's.  Every leaf comes back as a
    tensor of its saved dtype, on ``device`` if given, else on the device
    of the matching target leaf where that is a tensor, else on the CPU.
    ``shardings``, a tree of the target's structure with a
    ``distribution.sharding.Sharding`` a leaf, re-places every leaf on the
    current mesh: this rank's shard of it (elastic restore; no collective).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "bfloat16" in manifest["dtypes"]:
        raise ValueError(BF16_REFUSAL)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [data[f"a{i}"] for i in range(len(manifest["names"]))]

    names, tgt_leaves, unflatten = _flatten_with_names(target_tree)
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint/model structure mismatch:\n"
            f"ckpt: {manifest['names'][:5]}...\n"
            f"tgt : {names[:5]}..."
        )

    placements = [None] * len(leaves)
    if shardings is not None:
        from ..distribution.sharding import shard_tensor

        sh_names, placements, _ = _flatten_with_names(shardings)
        if sh_names != names:
            raise ValueError("the shardings tree does not match the checkpoint's")

    def place(arr, tgt, sharding):
        dev = device
        if dev is None:
            dev = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
        t = torch.from_numpy(arr)
        if sharding is not None:
            t = shard_tensor(t, sharding)
        return t.to(dev)

    restored = unflatten(
        [place(*x) for x in zip(leaves, tgt_leaves, placements, strict=True)]
    )
    return restored, manifest

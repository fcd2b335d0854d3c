"""Fault-tolerant training loop: checkpoint and restart, NaN recovery,
straggler watchdog, deterministic data replay.

Counterpart of ``repro.training.trainer``:

* process crash or preemption: ``Trainer.run`` resumes from the LATEST
  checkpoint, and the data source (step -> batch) replays the stream;
* a non-finite loss: restore the last checkpoint (or keep the state from
  before the step where none exists yet) and skip the step's data, at most
  ``max_nan_restores`` times;
* stragglers: a step slower than ``straggler_zscore`` standard deviations
  above the running mean is counted.

The step function is the port's (``make_train_step``): it updates the model
and the optimizer state in place, and leaves them as they were when the
loss is not finite, which the reference's trainer gets by throwing the
step's functional result away.

A checkpoint holds ``opt`` (step, f32 ``master``, ``m``, ``v``) and the
compression ``errors``, and no parameters: after every step
``p == master.to(p.dtype)`` bit for bit, so a restore rebuilds the
parameters from ``master``.  One rule for every dtype, and a bf16 model
checkpoints no bf16 leaf (the reference's trainer saves its bf16
parameters, which it cannot restore: ROADMAP Queue 3).

On a mesh (``shardings``: each parameter's ``distribution.sharding.Sharding``)
the parameters, the state and the errors are this rank's shards, and the
step is ``make_train_step(cfg, mesh, ...)``'s.  A save gathers every leaf
(a collective on every rank) and the mesh's rank 0 writes the whole tree,
so a checkpoint restores onto any mesh shape or one device; a restore
places each leaf by the shardings (``restore_checkpoint(shardings=)``).
After rank 0's write ends the ranks meet, so none reads ``LATEST`` before
it is flipped.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ..checkpointing.checkpoint import (
    AsyncCheckpointer,
    _flatten_with_names,
    latest_step,
    restore_checkpoint,
)
from .optimizer import AdamWState, adamw_init, param_list


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = dataclasses.field(default_factory=_default_checkpoint_dir)
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_zscore: float = 3.0
    max_nan_restores: int = 3


class Trainer:
    def __init__(
        self,
        step_fn: Callable,
        params,
        data_source,
        tcfg: TrainerConfig,
        grad_errors=None,
        fault_hook: Callable | None = None,
        shardings: list | None = None,
    ):
        self.step_fn = step_fn
        self.shardings = shardings
        self.params = params
        self.opt_state = adamw_init(params)
        self.grad_errors = grad_errors
        self.data = data_source
        self.cfg = tcfg
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir, tcfg.keep_checkpoints)
        self.fault_hook = fault_hook  # tests inject failures here
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self.nan_restores = 0
        self._durations: list[float] = []

    # -- checkpoint plumbing -------------------------------------------------

    def _state_tree(self):
        return dict(opt=self.opt_state, errors=self.grad_errors)

    def _state_shardings(self):
        """The shardings of ``_state_tree``'s leaves (None off a mesh)."""
        if self.shardings is None:
            return None
        from ..distribution.sharding import Sharding

        sh = list(self.shardings)
        step = Sharding(sh[0].mesh, ())
        errors = None if self.grad_errors is None else sh
        return dict(opt=AdamWState(step, sh, sh, sh), errors=errors)

    def _rank(self) -> int:
        import torch.distributed as dist

        return 0 if self.shardings is None else dist.get_rank()

    def save(self, step: int):
        tree = self._state_tree()
        if self.shardings is not None:
            from ..distribution.sharding import unshard_tensor

            _, leaves, unflatten = _flatten_with_names(tree)
            _, placed, _ = _flatten_with_names(self._state_shardings())
            tree = unflatten([unshard_tensor(x, s) for x, s in zip(leaves, placed)])
        if self._rank() == 0:
            self.ckpt.save(step, tree, extra=dict(step=step))

    def wait(self):
        """Join the outstanding write; on a mesh every rank then meets."""
        self.ckpt.wait()
        if self.shardings is not None:
            from ..launch.mesh import all_reduce_

            all_reduce_(torch.zeros(1, device=self.opt_state.master[0].device))

    def _restore(self, step: int | None = None):
        restored, _ = restore_checkpoint(
            self.cfg.checkpoint_dir,
            self._state_tree(),
            step,
            shardings=self._state_shardings(),
        )
        self.opt_state = restored["opt"]
        self.grad_errors = restored["errors"]
        with torch.no_grad():
            for p, master in zip(
                param_list(self.params), self.opt_state.master, strict=True
            ):
                p.copy_(master)

    def try_resume(self) -> int:
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return 0
        self._restore(step)
        return step

    # -- the loop -------------------------------------------------------------

    def _is_straggler(self, dt: float) -> bool:
        if len(self._durations) < 8:
            return False
        mu = float(np.mean(self._durations))
        sd = float(np.std(self._durations)) + 1e-9
        return (dt - mu) / sd > self.cfg.straggler_zscore

    def run(self, start_step: int | None = None) -> dict:
        step = self.try_resume() if start_step is None else start_step
        last_good = step
        while step < self.cfg.total_steps:
            batch = self.data.batch(step)
            if self.fault_hook is not None:
                self.fault_hook(step, batch)  # may raise / poison the batch
            t0 = time.monotonic()
            out = self.step_fn(self.params, self.opt_state, self.grad_errors, batch)
            params, opt_state, grad_errors, metrics = out
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0

            if not math.isfinite(loss):
                # NaN recovery: reload the last checkpoint, skip this batch.
                self.nan_restores += 1
                if self.nan_restores > self.cfg.max_nan_restores:
                    raise FloatingPointError(
                        f"loss non-finite at step {step}; restore budget spent"
                    )
                self.wait()
                if latest_step(self.cfg.checkpoint_dir) is not None:
                    self._restore()
                step += 1  # skip the poisoned data step
                continue

            self.params, self.opt_state, self.grad_errors = (
                params,
                opt_state,
                grad_errors,
            )
            if self._is_straggler(dt):
                self.straggler_steps.append(step)
            self._durations.append(dt)
            if len(self._durations) > 64:
                self._durations.pop(0)

            if step % self.cfg.log_every == 0:
                self.metrics_log.append(
                    dict(
                        step=step,
                        loss=loss,
                        dt=dt,
                        grad_norm=float(metrics["grad_norm"]),
                    )
                )
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.save(step)
                last_good = step

        self.save(self.cfg.total_steps)
        self.wait()
        return dict(
            final_step=step,
            last_checkpoint=last_good,
            nan_restores=self.nan_restores,
            stragglers=self.straggler_steps,
            log=self.metrics_log,
        )

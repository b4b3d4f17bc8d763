"""Fault-tolerant train loop: the port of ``repro.runtime.loop``.

* periodic checkpoints (keep-k, atomic, written on a thread from a host
  snapshot) and an exact restore of (state, step): a restart resumes
  where the last checkpoint left off;
* a NaN / inf guard: a step whose loss is not finite is skipped, its
  state not committed, and counted; ``max_bad_steps`` consecutive ones
  raise ``FloatingPointError``;
* deterministic data: ``batches(step)`` is a function of the step
  (``repro_torch.data.TokenStream``), so a restarted job neither replays
  nor skips a batch;
* device-agnostic restore: checkpoints are host arrays, and
  ``try_restore(device=, map_fn=)`` puts each leaf where the caller says.

The reference's step is a pure function, so its loop commits a step by
keeping ``new_state`` and skips one by dropping it.  The port's train
step (``repro_torch.launch.steps.make_train_step``) updates its state in
place, so it is the step that must leave every tensor untouched when the
loss is not finite; the loop then keeps the state it holds either way.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class TrainLoopCfg:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    async_save: bool = True
    max_bad_steps: int = 10


class TrainLoop:
    """Drives ``step_fn(state, batch) -> (state, loss)`` over a data
    stream with checkpoint / restart."""

    def __init__(self, cfg: TrainLoopCfg,
                 step_fn: Callable[[Any, dict], tuple[Any, Any]],
                 state: Any):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.step = 0
        self.bad_steps = 0
        self.metrics: list[tuple[int, float]] = []
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                     async_save=cfg.async_save)

    def try_restore(self, device=None, map_fn=None) -> bool:
        """Restore the latest checkpoint into the state's structure (on
        ``device``, or each leaf's own); False when there is none."""
        out = self.mgr.restore_latest(
            {"state": self.state, "step": np.asarray(self.step)}, device,
            map_fn)
        if out is None:
            return False
        _, tree = out
        self.state = tree["state"]
        self.step = int(tree["step"])
        log.info("restored checkpoint at step %d", self.step)
        return True

    def run(self, batches: Callable[[int], dict], n_steps: int) -> Any:
        """Run until ``self.step == n_steps``; returns the state."""
        while self.step < n_steps:
            batch = batches(self.step)
            new_state, loss = self.step_fn(self.state, batch)
            loss_val = float(loss)
            if not math.isfinite(loss_val):
                # Skip the step: do not commit state.  Deterministic data
                # means a post-restart replay hits the same batch, so the
                # loop also advances past it.
                self.bad_steps += 1
                log.warning("non-finite loss at step %d (%d consecutive)",
                            self.step, self.bad_steps)
                if self.bad_steps >= self.cfg.max_bad_steps:
                    raise FloatingPointError(
                        f"{self.bad_steps} consecutive non-finite steps; "
                        "restore from checkpoint and lower lr")
                self.step += 1
                continue
            self.bad_steps = 0
            self.state = new_state
            self.metrics.append((self.step, loss_val))
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self.mgr.save(self.step, {"state": self.state,
                                          "step": np.asarray(self.step)})
        self.mgr.wait()
        return self.state

"""Fault-tolerant training loop of the port.

Wraps a train step with the reference's runbook:

  * **restore-on-start** from the latest checkpoint (data cursor included);
  * **NaN / exception quarantine**: a non-finite loss or a device exception
    skips the step, increments a strike counter, and after ``max_strikes``
    consecutive bad steps reloads the last checkpoint (skip-and-reload).
    The port's step updates in place and applies nothing when its loss is
    not finite (``train.step``), so a skipped step leaves the state as it
    was, as the reference's discarded functional state does; a step that
    raised part-way is repaired by the reload;
  * **straggler detection**: per-step wall time EMA + variance; steps
    slower than ``straggler_z`` standard deviations are logged;
  * **periodic async checkpoints** + SIGTERM checkpoint-and-exit.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Iterator, Optional


from repro_torch.train.checkpoint import (CheckpointManager,
                                          install_sigterm_handler)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    max_strikes: int = 3  # consecutive bad steps before reload
    straggler_z: float = 3.0
    straggler_warmup: int = 5  # steps before the EMA is trusted
    handle_sigterm: bool = False


@dataclasses.dataclass
class LoopStats:
    steps_run: int = 0
    steps_skipped: int = 0
    reloads: int = 0
    stragglers: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)


class TrainLoop:
    def __init__(self, train_step: Callable, state, data_iter: Iterator,
                 ckpt: Optional[CheckpointManager] = None,
                 cfg: LoopConfig = LoopConfig()):
        self.train_step = train_step
        self.state = state
        self.data = data_iter
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = LoopStats()
        self._ema_t = None
        self._ema_v = 0.0
        self._strikes = 0

    # -- fault-tolerance pieces ----------------------------------------------

    def _restore(self):
        if self.ckpt is None:
            return
        restored = self.ckpt.restore(self.state)
        if restored is not None:
            self.state, meta = restored
            cursor = meta["extra"].get("data_cursor")
            if cursor is not None and hasattr(self.data, "seek"):
                self.data.seek(cursor)
            log.info("restored checkpoint at step %s", meta["step"])

    def _save(self, blocking=False):
        if self.ckpt is None:
            return
        step = int(self.state.step)
        extra = {}
        if hasattr(self.data, "cursor"):
            extra["data_cursor"] = self.data.cursor()
        self.ckpt.save(step, self.state, blocking=blocking, extra=extra)

    def _track_time(self, step_idx: int, dt: float):
        if self._ema_t is None:
            self._ema_t = dt
            return
        z = 0.0
        sd = math.sqrt(self._ema_v) if self._ema_v > 0 else 0.0
        if sd > 0 and step_idx >= self.cfg.straggler_warmup:
            z = (dt - self._ema_t) / sd
            if z > self.cfg.straggler_z:
                self.stats.stragglers.append((step_idx, dt, z))
                log.warning("straggler step %d: %.3fs (z=%.1f)", step_idx,
                            dt, z)
        a = 0.1
        self._ema_v = (1 - a) * (self._ema_v + a * (dt - self._ema_t) ** 2)
        self._ema_t = (1 - a) * self._ema_t + a * dt

    # -- main ---------------------------------------------------------------

    def run(self) -> LoopStats:
        self._restore()
        if self.cfg.handle_sigterm:
            install_sigterm_handler(lambda: self._save(blocking=True))
        start = int(self.state.step)
        for i in range(start, self.cfg.total_steps):
            batch = next(self.data)
            t0 = time.perf_counter()
            try:
                new_state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])  # waits for the step
            except (FloatingPointError, RuntimeError) as e:  # device fault
                log.error("step %d raised %r — skipping", i, e)
                loss = float("nan")
                new_state = None
            dt = time.perf_counter() - t0
            self._track_time(i, dt)

            if new_state is None or not math.isfinite(loss):
                self.stats.steps_skipped += 1
                self._strikes += 1
                if (self._strikes >= self.cfg.max_strikes
                        and self.ckpt is not None):
                    log.error("%d consecutive bad steps — reloading "
                              "checkpoint", self._strikes)
                    self._restore()
                    self.stats.reloads += 1
                    self._strikes = 0
                continue  # quarantine: state unchanged

            self._strikes = 0
            self.state = new_state
            self.stats.steps_run += 1
            self.stats.losses.append(loss)
            if i % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", i, loss, dt)
            if (self.ckpt is not None
                    and (i + 1) % self.cfg.checkpoint_every == 0):
                self._save()
        self._save(blocking=True)
        return self.stats




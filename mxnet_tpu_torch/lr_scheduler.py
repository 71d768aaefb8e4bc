"""Learning-rate schedulers of the port (a copy of
``mxnet_tpu/lr_scheduler.py``; parity: python/mxnet/lr_scheduler.py).

A scheduler is ``callable(num_update) -> lr``.  ``FusedTrainer`` calls
it on the host once per step, ``step_multi``'s k steps included, and
hands the value to the step as an fp32 scalar on the device."""
from __future__ import annotations

import logging
import math


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (parity: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("lr hit stop_factor_lr %.2e", self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given update milestones (parity: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class WarmupCosineScheduler(LRScheduler):
    """Linear warmup to base_lr, then cosine decay to ``final_lr`` over
    ``total_steps`` (beyond-reference: the transformer-era schedule;
    the v0.9.4 reference ships only Factor/MultiFactor).  Stateless in
    num_update, so checkpoint resume lands on the exact same curve."""

    def __init__(self, total_steps, warmup_steps=0, final_lr=0.0):
        super().__init__()
        if total_steps < 1:
            raise ValueError("total_steps must be >= 1")
        if not 0 <= warmup_steps < total_steps:
            raise ValueError("need 0 <= warmup_steps < total_steps")
        self.total_steps = int(total_steps)
        self.warmup_steps = int(warmup_steps)
        self.final_lr = float(final_lr)

    def __call__(self, num_update):
        if self.warmup_steps and num_update <= self.warmup_steps:
            return self.base_lr * num_update / self.warmup_steps
        t = min(num_update, self.total_steps) - self.warmup_steps
        span = self.total_steps - self.warmup_steps
        cos = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.final_lr + (self.base_lr - self.final_lr) * cos

"""Closed-form LR policies, cosine with warmup and relative steps
(counterpart of pytorchvideo_tpu/train/lr_policy.py; upstream
module/lr_policy.py:41-146). ``cur_epoch`` is a float (epoch + batch /
batches), as the reference's per-step manual LR updates use it."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass
class LRSchedulerConfig:
    lr_policy: str = "cosine"
    lr: float = 0.1
    max_iters: int = 100
    warmup_iters: int = 0
    warmup_start_lr: float = 0.0
    cosine_end_lr: float = 0.0
    cosine_after_warmup: bool = False
    steps: List[int] = field(default_factory=list)
    lrs: List[float] = field(default_factory=list)


def lr_func_cosine(cfg: LRSchedulerConfig, cur_epoch: float) -> float:
    offset = cfg.warmup_iters if cfg.cosine_after_warmup else 0.0
    if not cfg.cosine_end_lr < cfg.lr:
        raise ValueError(f"cosine_end_lr {cfg.cosine_end_lr} must be below lr {cfg.lr}")
    return cfg.cosine_end_lr + (cfg.lr - cfg.cosine_end_lr) * (
        math.cos(math.pi * (cur_epoch - offset) / (cfg.max_iters - offset)) + 1.0
    ) * 0.5


def get_step_index(cfg: LRSchedulerConfig, cur_epoch: float) -> int:
    steps = list(cfg.steps) + [cfg.max_iters]
    ind = 0
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def lr_func_steps_with_relative_lrs(cfg: LRSchedulerConfig, cur_epoch: float) -> float:
    return cfg.lrs[get_step_index(cfg, cur_epoch)] * cfg.lr


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
}


def get_lr_at_epoch(cfg: LRSchedulerConfig, cur_epoch: float) -> float:
    """LR with a linear warmup toward the policy's value at the warmup's end."""
    if cfg.lr_policy not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {cfg.lr_policy}")
    lr = _POLICIES[cfg.lr_policy](cfg, cur_epoch)
    if cur_epoch < cfg.warmup_iters:
        lr_start = cfg.warmup_start_lr
        lr_end = _POLICIES[cfg.lr_policy](cfg, cfg.warmup_iters)
        alpha = (lr_end - lr_start) / cfg.warmup_iters
        lr = cur_epoch * alpha + lr_start
    return lr


get_epoch_lr = get_lr_at_epoch

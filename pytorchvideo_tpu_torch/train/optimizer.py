"""Optimizer construction over the JAX package's parameter groups
(counterpart of pytorchvideo_tpu/train/optimizer.py; upstream
module/optimizer.py:26-236).

Every parameter gets one label, as ``_param_labels`` gives it in the JAX
package:

- "bn": the weight and bias of a norm module (LayerNorm or BatchNorm), with
  ``bn_weight_decay``;
- "zero": with ``zero_weight_decay_1d_param``, any other parameter of at most
  one dimension or named ``bias``, with no weight decay;
- "main": everything else (``pos_embed_*`` and ``cls_token`` included, being
  3-D), with ``weight_decay``.

The optax chains map onto ``torch.optim`` exactly: sgd is
add_decayed_weights -> trace(momentum, nesterov) -> scale(-lr), which is
``torch.optim.SGD`` with the group's weight decay; adam and adamw are both
scale_by_adam -> add_decayed_weights -> scale(-lr) in the JAX package, that is
decoupled weight decay scaled by the LR, which is ``torch.optim.AdamW``.
sgd with ``lars_on`` is add_decayed_weights -> scale_by_trust_ratio on the
"main" and "zero" groups (identity on "bn") -> trace -> scale(-lr), where
``torch.optim.SGD`` has no place for the ratio between the decay and the
momentum: that is :class:`LARS`. The JAX docstring says the ratio applies
to non-BN params with ``ignore_1d_param=True``; its chain also scales the
1-D "zero" group, and the port follows the chain.

:func:`lr_schedule_from_config` is the per-step closed-form schedule
(upstream's manual_update_lr); the train step sets it on every group before
each update, indexed by the number of updates made so far, from 0, as
``optax.scale_by_schedule`` counts.

The LR lives on the device: one 0-d tensor per optimizer, on the
parameters' device, is every group's ``lr``, and the step writes the
schedule's value into it (:func:`set_lr`) before each update. A CUDA graph
of the step (train/compiled_step.py) then reads the LR of each replay,
where a float LR would be baked into the graph. On the card the optimizers
are the forms that read it there: ``AdamW(capturable=True)`` and
``SGD(fused=True)`` (the foreach SGD takes a tensor LR as a host scalar, a
read that a capture cannot hold). The tensor is float32 on the card (the
kernels' type, and the JAX package's f32 schedule) and float64 on the CPU,
where it holds the Python float exactly, so a CPU update equals the
float-LR one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn as nn

from pytorchvideo_tpu_torch.train.lr_policy import LRSchedulerConfig, get_lr_at_epoch

GROUPS = ("main", "zero", "bn")
_NORMS = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)


@dataclass
class OptimizerConfig:
    method: str = "sgd"  # sgd | adam | adamw
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bn_weight_decay: float = 0.0
    nesterov: bool = False
    zero_weight_decay_1d_param: bool = False
    lars_on: bool = False


def param_labels(model: nn.Module, zero_wd_1d: bool) -> Dict[str, str]:
    """{parameter name: "bn" | "zero" | "main"} (JAX optimizer.py:36-47)."""
    labels = {}
    for module_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{module_name}.{name}" if module_name else name
            if isinstance(module, _NORMS):
                labels[full] = "bn"
            elif zero_wd_1d and (p.dim() <= 1 or name == "bias"):
                labels[full] = "zero"
            else:
                labels[full] = "main"
    return labels


def lr_schedule_from_config(cfg: LRSchedulerConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> LR, the closed form of :func:`get_lr_at_epoch` at epoch
    step / steps_per_epoch (JAX optimizer.py:50-88)."""
    return lambda step: get_lr_at_epoch(cfg, step / steps_per_epoch)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Writes ``lr`` into every group: in place into a tensor LR (one
    ``fill_``, which the device runs in stream order), as a float otherwise."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict`` that keeps the optimizer's own LR tensor
    (its dtype and device) as every group's ``lr``, with the loaded value."""
    lr = optimizer.param_groups[0]["lr"]
    optimizer.load_state_dict(state_dict)
    if isinstance(lr, torch.Tensor):
        with torch.no_grad():
            lr.copy_(torch.as_tensor(optimizer.param_groups[0]["lr"]))
        for group in optimizer.param_groups:
            group["lr"] = lr


class LARS(torch.optim.Optimizer):
    """SGD with a layer-wise trust ratio between the weight decay and the
    momentum, the JAX package's ``lars_on`` chain (JAX optimizer.py:109-120):
    per tensor, ``u = g + wd * p``; in a group with ``trust_ratio`` set,
    ``u *= |p| / |u|`` (L2 norms over the tensor; 1 where either norm is 0,
    as ``optax.scale_by_trust_ratio`` takes it, so a zero-initialised bias
    takes a whole step); ``m = u + momentum * m`` from ``m = 0``; ``p -= lr
    * (u + momentum * m if nesterov else m)``.

    The ratio is a ``torch.where`` on the device, so a step reads nothing
    back to the host and a CUDA graph can hold it; ``lr`` may be a 0-d
    tensor (read where it lies at each step, so a replay sees the value
    written before it) or a float."""

    def __init__(self, params, lr=0.1, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False, trust_ratio: bool = True):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      nesterov=nesterov, trust_ratio=trust_ratio))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                updates = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            else:
                updates = [g.clone() for g in grads]
            if group["trust_ratio"]:
                p_norms = torch._foreach_norm(params)
                u_norms = torch._foreach_norm(updates)
                ratios = [torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                          for pn, un in zip(p_norms, u_norms)]
                torch._foreach_mul_(updates, ratios)
            buffers = []
            for p in params:
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buffers.append(state["momentum_buffer"])
            torch._foreach_mul_(buffers, group["momentum"])
            torch._foreach_add_(buffers, updates)
            if group["nesterov"]:
                torch._foreach_add_(updates, buffers, alpha=group["momentum"])
            else:
                updates = buffers
            lr = group["lr"]
            if isinstance(lr, torch.Tensor) and lr.device.type == "cpu":
                lr = lr.item()
            if isinstance(lr, torch.Tensor):
                torch._foreach_sub_(params, torch._foreach_mul(updates, lr))
            else:
                torch._foreach_add_(params, updates, alpha=-lr)
        return loss


def construct_optimizer(model: nn.Module, cfg: OptimizerConfig) -> torch.optim.Optimizer:
    """The optimizer over ``model``'s trainable parameters in the JAX
    package's groups; each group carries its ``label``, and all share one
    0-d LR tensor on the parameters' device (see the module docstring).
    sgd with ``lars_on`` is :class:`LARS`, its trust ratio on the "main" and
    "zero" groups."""
    labels = param_labels(model, cfg.zero_weight_decay_1d_param)
    wd = {"bn": cfg.bn_weight_decay, "zero": 0.0, "main": cfg.weight_decay}
    params = dict(model.named_parameters())
    groups = []
    for label in GROUPS:
        members = [params[n] for n, lab in labels.items()
                   if lab == label and params[n].requires_grad]
        if members:
            groups.append({"params": members, "weight_decay": wd[label], "label": label})
    if cfg.method not in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"optimizer {cfg.method}")
    device = next(iter(params.values())).device
    on_card = device.type == "cuda"
    lr = torch.tensor(cfg.lr, dtype=torch.float32 if on_card else torch.float64, device=device)
    if cfg.method == "sgd" and cfg.lars_on:
        for group in groups:
            group["trust_ratio"] = group["label"] != "bn"
        return LARS(groups, lr=lr, momentum=cfg.momentum, nesterov=cfg.nesterov)
    if cfg.method == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum, nesterov=cfg.nesterov,
                               fused=True if on_card else None)
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=on_card)

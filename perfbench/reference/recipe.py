"""The plain training step of a classification recipe, in float32 (or, for
the control, at a lower precision), written from the recipe's stated
numbers, which the traffic file holds and hands to the program too:

- MixVideo (pytorchvideo's ``MixVideo``): a coin drawn from a CPU
  generator picks CutMix (probability ``cutmix_prob``) or MixUp; lambda is
  Beta(alpha, alpha) as the ratio of two Gamma draws (Marsaglia and
  Tsang); CutMix's box is centred on a uniform cell and lambda corrected
  by its area; each sample is mixed with its batch flip, and its one-hot
  labels, smoothed by ``label_smoothing``, likewise. The draws are made in
  the order the program's step makes them, from a generator seeded alike.
- the model's forward in training, whose dropout masks are drawn in the
  order of the steps from a generator on the batch's device seeded with
  ``dropout_seed``, as the program draws them from the device's default
  generator seeded alike;
- the soft-target cross entropy, averaged over the batch;
- the gradient clipped by its global norm (scale min(1, max / (norm + 1e-6)));
- AdamW with decoupled weight decay (none on 1-D leaves: biases and norms);
- the LR of update ``s`` at epoch ``s / steps_per_epoch``: a linear
  warm-up to the cosine's value at its end, then the cosine (after the
  warm-up) to ``cosine_end_lr``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.common import lowp


def _uniform(g) -> float:
    return float(torch.rand((), generator=g))


def _gamma(alpha: float, g) -> float:
    if alpha < 1.0:
        return _gamma(alpha + 1.0, g) * _uniform(g) ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=g))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = _uniform(g)
        if math.log(max(u, 1e-300)) < 0.5 * z * z + d - d * v + d * math.log(v):
            return d * v


def _beta(alpha: float, g) -> float:
    x, y = _gamma(alpha, g), _gamma(alpha, g)
    return x / (x + y)


def soft_labels(labels: torch.Tensor, classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / classes
    return F.one_hot(labels.long(), classes).float() * (1.0 - smoothing) + off


def mix(video: torch.Tensor, labels: torch.Tensor, recipe: dict, classes: int, g):
    """(mixed NCTHW video, soft labels) of one batch; draws from ``g``."""
    smoothing = recipe["label_smoothing"]
    if _uniform(g) < recipe["cutmix_prob"]:
        lam = _beta(recipe["cutmix_alpha"], g)
        h, w = video.shape[-2:]
        cy = int(torch.randint(0, h, (), generator=g))
        cx = int(torch.randint(0, w, (), generator=g))
        ratio = math.sqrt(1.0 - lam)
        ch, cw = int(math.floor(h * ratio)), int(math.floor(w * ratio))
        y0, y1 = min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h)
        x0, x1 = min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w)
        mixed = video.clone()
        mixed[..., y0:y1, x0:x1] = video.flip(0)[..., y0:y1, x0:x1]
        lam = 1.0 - (y1 - y0) * (x1 - x0) / float(h * w)
    else:
        lam = _beta(recipe["mixup_alpha"], g)
        mixed = video * lam + video.flip(0) * (1.0 - lam)
    target = (soft_labels(labels, classes, smoothing) * lam
              + soft_labels(labels.flip(0), classes, smoothing) * (1.0 - lam))
    return mixed, target


def soft_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    target = target / (1e-12 + target.sum(dim=1, keepdim=True))
    return -(target * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


def lr_at(schedule: dict, epoch: float) -> float:
    offset = schedule["warmup_epochs"] if schedule["cosine_after_warmup"] else 0.0

    def cosine(e):
        return schedule["cosine_end_lr"] + (schedule["lr"] - schedule["cosine_end_lr"]) * (
            math.cos(math.pi * (e - offset) / (schedule["max_epochs"] - offset)) + 1.0) * 0.5

    if epoch < schedule["warmup_epochs"]:
        end = cosine(schedule["warmup_epochs"])
        return epoch * (end - schedule["warmup_start_lr"]) / schedule["warmup_epochs"] \
            + schedule["warmup_start_lr"]
    return cosine(epoch)


def train(forward: Callable, weights: Dict[str, torch.Tensor], batches: List[tuple],
          recipe: dict, classes: int, seed: int, steps_per_epoch: int,
          control: Optional[torch.dtype] = None, gradient_steps: Iterable[int] = (1,),
          dropout_seed: int = 0) -> dict:
    """``len(batches)`` updates from ``weights`` (left unchanged) on
    ``(video, labels)`` batches, ``forward(w, video, control, masks)`` the
    model in training, ``masks`` the generator of its dropout. Returns
    {"losses": [...], "grads": {step: {leaf: that update's clipped
    gradient}} for each of ``gradient_steps`` (counted from 1),
    "params": {leaf: after the last update}}."""
    g = torch.Generator().manual_seed(int(seed))
    masks = torch.Generator(device=batches[0][0].device).manual_seed(int(dropout_seed))
    w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2 = recipe["betas"]
    out = {"losses": [], "grads": {}}
    for step, (video, labels) in enumerate(batches):
        mixed, target = mix(video, labels, recipe, classes, g)
        loss = soft_cross_entropy(forward(w, mixed, control, masks), target)
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(w.values(), grads)]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(gr) for gr in grads]))
        scale = torch.clamp(recipe["clip_grad_norm"] / (norm + 1e-6), max=1.0)
        grads = [lowp(gr * scale, control) for gr in grads]
        lr = lr_at(recipe["schedule"], step / steps_per_epoch)
        t = step + 1
        with torch.no_grad():
            for (k, p), gr in zip(w.items(), grads):
                wd = 0.0 if p.dim() <= 1 else recipe["weight_decay"]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(gr, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(gr, gr, value=1.0 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(recipe["eps"])
                p.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** t))
        if t in gradient_steps:
            out["grads"][t] = {k: gr.detach() for k, gr in zip(w, grads)}
        out["losses"].append(float(loss.detach()))
    out["params"] = {k: p.detach() for k, p in w.items()}
    return out


def reached(grads: Dict[str, torch.Tensor], floor_share: float = 1e-3) -> set:
    """The leaves whose gradient norm is at least ``floor_share`` of the
    median leaf's: the others' gradients are nought to rounding (a key's
    bias under the softmax), and Adam moves them by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {k for k, n in norms.items() if n >= floor_share * median}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], leaves: set,
             own: bool = False):
    """(worst leaf's gap, its name): over ``leaves``, the gap between the
    program's L2 norm of a leaf and the reference's, against the larger of
    the reference leaf's norm and the median leaf's (over all leaves), or,
    with ``own``, against the reference leaf's norm alone."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in reference.items()}
    median = sorted(norms.values())[len(norms) // 2]
    worst, name = 0.0, None
    for k in sorted(leaves):
        gap = abs(float(torch.linalg.vector_norm(program[k].float())) - norms[k]) / (
            norms[k] if own else max(norms[k], median))
        if not gap <= worst:  # a NaN gap is the worst
            worst, name = gap, k
    return worst, name

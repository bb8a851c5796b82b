"""Seeded weights, made on the device in a few large draws.

A reference module lists its leaves as ``(name, shape, init)``, ``init``
one of ``("normal", std)``, ``("uniform", low, high)`` or ``("const",
value)``. Every normal leaf is cut from one ``torch.randn`` and every
uniform leaf from one ``torch.rand`` of a generator on the device seeded
from the run's seed, then scaled by one multiply with each leaf's factor
repeated over its elements. The same seed gives the same weights.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple[str, Sequence[int], tuple]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def draw(specs: List[Spec], seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """name -> tensor for every leaf of ``specs``, in float32 on ``device``."""
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for kind in ("normal", "uniform"):
        leaves = [(name, tuple(shape), init) for name, shape, init in specs if init[0] == kind]
        if not leaves:
            continue
        numels = [_numel(shape) for _, shape, _ in leaves]
        total = sum(numels)
        if kind == "normal":
            flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
            scale = torch.tensor([init[1] for _, _, init in leaves], device=device, dtype=dtype)
            shift = torch.zeros_like(scale)
        else:
            flat = torch.rand(total, generator=generator, device=device, dtype=dtype)
            scale = torch.tensor([init[2] - init[1] for _, _, init in leaves], device=device,
                                 dtype=dtype)
            shift = torch.tensor([init[1] for _, _, init in leaves], device=device, dtype=dtype)
        counts = torch.tensor(numels, device=device)
        flat.mul_(torch.repeat_interleave(scale, counts)).add_(
            torch.repeat_interleave(shift, counts))
        for (name, shape, _), piece in zip(leaves, torch.split(flat, numels)):
            out[name] = piece.view(shape)
    for name, shape, init in specs:
        if init[0] == "const":
            out[name] = torch.full(tuple(shape), float(init[1]), device=device, dtype=dtype)
        elif init[0] not in ("normal", "uniform"):
            raise ValueError(f"{name}: unknown init {init!r}")
    return {name: out[name] for name, _, _ in specs}

"""Model complexity: FLOP and parameter counts.

Counterpart of pytorchvideo_tpu/utils/flops.py. The JAX package reads XLA's
cost model of the compiled program (``cost_analysis()["flops"]``), which
counts elementwise ops too. Here ``torch.utils.flop_counter.FlopCounterMode``
counts the products, convolutions and attention of one forward, 2 FLOPs
per multiply-add, and nothing elementwise. The ``pvt::`` custom ops have no
formula, so :func:`model_complexity` runs the train-form forward on a CPU
copy of the model, where every kernel dispatcher takes its plain version:
the count is the same wherever the model lives.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Sequence, Union

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

# A BatchNorm's buffers: in a state_dict, not among the parameters (the JAX
# package keeps them in ``batch_stats``, apart from ``params``).
_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def count_params(module_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """The parameter count: a module's parameters, or a ``state_dict``'s
    entries but the BatchNorm buffers."""
    if isinstance(module_or_state_dict, nn.Module):
        return sum(p.numel() for p in module_or_state_dict.parameters())
    return sum(t.numel() for name, t in module_or_state_dict.items()
               if not name.endswith(_BUFFER_SUFFIXES))


def flops_of(fn, *args) -> float:
    """FLOPs of one call ``fn(*args)``, 2 per multiply-add (products,
    convolutions, attention), under ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def model_complexity(model: nn.Module, input_shape: Union[Sequence[int], Sequence[Sequence[int]]],
                     dtype: torch.dtype = torch.float32, train: bool = False) -> Dict[str, float]:
    """{"gflops": one clip's forward in GFLOPs, "params_m": parameters in
    millions}. ``input_shape`` is one clip's (C, T, H, W), or a list of them
    for a pathway model (SlowFast). The forward runs on a CPU copy of
    ``model`` in ``dtype``, in train mode if ``train`` (eval otherwise), on
    zeros; ``model`` is left as it is."""
    shapes = list(input_shape) if isinstance(input_shape[0], (list, tuple)) else [input_shape]
    clips = [torch.zeros((1, *shape), dtype=dtype) for shape in shapes]
    cpu = copy.deepcopy(model).to("cpu", dtype).train(train)
    flops = flops_of(cpu, clips if len(clips) > 1 else clips[0])
    return {"gflops": flops / 1e9, "params_m": count_params(model) / 1e6}

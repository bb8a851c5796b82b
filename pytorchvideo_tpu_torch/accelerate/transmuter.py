"""Model transmuter: a registry of target-specific rewrite passes.

Counterpart of pytorchvideo_tpu/accelerate/transmuter.py (upstream
accelerator/deployment/common/model_transmuter.py:77-147). The JAX package's
passes rewrite (model, variables) pairs for its ``"tpu"`` target; here a pass
rewrites a module tree. Each pass is ``fn(model, **kwargs)`` and returns the
rewritten model, or None where it changed nothing.

The ``"cuda"`` target holds the deploy form's three passes
(accelerate/deploy.py): fold BN where there is any (``_tpu_fold_bn``), put
the folded stride-1 depthwise convs on the kernel, cast to ``dtype``
(bfloat16 unless given; None keeps the weights' dtype). The deploy form
itself, ``convert_to_deployable_form``, is this target's transmutation. The
port has no ``"tpu"`` target: an unregistered target raises, as
``"mobile_cpu"`` does in the JAX package.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, List

import torch.nn as nn

from pytorchvideo_tpu_torch.accelerate.deploy import cast_pass, fold_bn_pass, kernel_pass

logger = logging.getLogger(__name__)

# target device -> ordered list of passes, each (model, **kwargs) -> model or None.
EFFICIENT_BLOCK_TRANSMUTER_REGISTRY: Dict[str, List[Callable]] = {}


def register_transmuter(target_device: str, fn: Callable) -> Callable:
    EFFICIENT_BLOCK_TRANSMUTER_REGISTRY.setdefault(target_device, []).append(fn)
    return fn


def transmute_model(model: nn.Module, target_device: str = "cuda", **kwargs) -> nn.Module:
    """Runs the target's passes in order on an eval-mode copy of ``model``
    (which is left unchanged) and returns the copy. ``kwargs`` go to every
    pass (the ``"cuda"`` target reads ``dtype`` and ``fold_bn``)."""
    if target_device not in EFFICIENT_BLOCK_TRANSMUTER_REGISTRY:
        raise ValueError(f"{target_device!r} is not registered; available: "
                         f"{list(EFFICIENT_BLOCK_TRANSMUTER_REGISTRY)}")
    model = copy.deepcopy(model).eval()
    for fn in EFFICIENT_BLOCK_TRANSMUTER_REGISTRY[target_device]:
        result = fn(model, **kwargs)
        if result is not None:
            model = result
            logger.info("transmuter pass %s applied", fn.__name__)
    return model


register_transmuter("cuda", fold_bn_pass)
register_transmuter("cuda", kernel_pass)
register_transmuter("cuda", cast_pass)

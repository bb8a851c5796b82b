"""Hub utilities: building a named model and loading a local checkpoint
(counterpart of pytorchvideo_tpu/models/hub/utils.py; upstream
models/hub/utils.py:12-49).

Upstream's ``.pyth`` files hold ``{"model_state": state_dict}``, and the
port's modules keep upstream's ``state_dict`` keys, so loading one is a
``load_state_dict``. Nothing is downloaded: a checkpoint is a local path or
an already loaded dict. ``MODEL_ZOO_ROOT_DIR`` names where upstream's files
are published.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

MODEL_ZOO_ROOT_DIR = "https://dl.fbaipublicfiles.com/pytorchvideo/model_zoo"


def hub_model_builder(
    model_builder_func: Callable[..., nn.Module],
    pretrained: bool = False,
    checkpoint_path: str = "",
    default_config: Optional[dict] = None,
    example_input=None,
    rename_rules: Optional[Sequence[Tuple[str, str]]] = None,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
) -> nn.Module:
    """``model_builder_func(device=device, **kwargs)``, with each keyword
    that is unset or None taken from ``default_config``; with ``pretrained``,
    the weights of ``checkpoint_path`` (a local ``.pyth``) loaded by
    :func:`load_pretrained_variables`, and then no other keyword may be
    given.

    Returns the model, which carries its weights, whether or not
    ``pretrained``: the JAX function returns ``(model, variables)`` when
    ``pretrained``, since a flax module holds no state. ``example_input``,
    which the JAX function needs to initialise the variables' shapes, is
    accepted and not used."""
    if pretrained and kwargs:
        raise ValueError(f"a pretrained model takes its default config; got {sorted(kwargs)}")
    for argument, value in (default_config or {}).items():
        if kwargs.get(argument) is None:
            kwargs[argument] = value
    model = model_builder_func(device=device, **kwargs)
    if pretrained:
        load_pretrained_variables(model, example_input, checkpoint_path, rename_rules)
    return model


def load_pretrained_variables(
    model: nn.Module,
    example_input,
    checkpoint: Union[str, Mapping],
    rename_rules: Optional[Sequence[Tuple[str, str]]] = None,
    strict: bool = True,
) -> nn.Module:
    """Loads ``checkpoint`` into ``model`` and returns ``model``.

    ``checkpoint`` is the path of a ``.pyth`` file (read with
    ``torch.load(weights_only=True)``), a loaded ``{"model_state": ...}``
    dict or a bare ``state_dict``. ``rename_rules`` are regex (pattern,
    replacement) pairs applied in turn to each key (as the JAX importer
    applies them); then ``model.load_state_dict(state, strict=strict)``,
    which raises on missing or unexpected keys when ``strict``. The tensors
    are copied to wherever the model's parameters are. The JAX function
    returns ``(variables, report)``; here the module is the state, and
    ``example_input`` is accepted and not used."""
    if isinstance(checkpoint, (str, bytes)):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    state = checkpoint.get("model_state", checkpoint)
    renamed = {}
    for key, value in state.items():
        for pattern, replacement in rename_rules or ():
            key = re.sub(pattern, replacement, key)
        renamed[key] = value
    model.load_state_dict(renamed, strict=strict)
    return model

"""Efficient-block protocol: a train form and a deploy form.

Counterpart of pytorchvideo_tpu/accelerate/efficient_blocks.py (upstream
accelerator/efficient_blocks/efficient_block_base.py:8-35 and
no_op_convert_block.py:43). As upstream's, a block is an ``nn.Module`` with a
``convert()`` method. The JAX package's (module, variables) pair becomes the
train-form module ``.model``; ``convert()`` builds the deploy form beside it
(``.deploy_form``, not a submodule, so the ``state_dict`` stays the train
form's), and in eval mode ``forward`` casts its input to the deploy dtype and
runs the deploy form, as the JAX ``__call__`` does. In train mode ``forward``
runs the train form. Convert after the model is on its device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn


class EfficientBlockBase(nn.Module):
    """A module with a train -> deploy conversion."""

    def convert(self, example_input=None, **kwargs) -> "EfficientBlockBase":
        """Produce the deployable form (folded, cast, on the kernels)."""
        raise NotImplementedError


class NoOpConvertBlock(EfficientBlockBase):
    """Wraps a module that needs no conversion (upstream
    no_op_convert_block.py:43)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def convert(self, example_input=None, **kwargs) -> "NoOpConvertBlock":
        return self

    def forward(self, x):
        return self.model(x)


class TrainAndDeployForms(EfficientBlockBase):
    """The train form ``.model``, and after ``convert()`` the deploy form
    ``.deploy_form`` (a module, or a :class:`CompiledForward`) with its dtype
    ``.deploy_dtype``, which eval-mode calls take."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self._set_deploy(None, None)

    def _set_deploy(self, deploy, dtype: Optional[torch.dtype]) -> None:
        # Kept out of the module tree: .train(), .to() and the state_dict
        # see the train form only.
        object.__setattr__(self, "deploy_form", deploy)
        self.deploy_dtype = dtype

    def forward(self, x):
        if self.deploy_form is not None and not self.training:
            if self.deploy_dtype is not None:
                x = x.to(self.deploy_dtype)
            return self.deploy_form(x)
        return self.model(x)


class EfficientX3d(TrainAndDeployForms):
    """X3D assembled for deployment (upstream
    models/accelerator/mobile_cpu/efficient_x3d.py:20-206). As in the JAX
    package it is ``create_x3d``'s swish X3D, not upstream's mobile-CPU
    ReLU/hswish network; ``convert()`` is the deploy form
    (``convert_to_deployable_form``): BN folded, the 22 stride-1 ``conv_b``
    of X3D-S (22 of X3D-XS) on the depthwise kernel, bf16."""

    _EXPANSION_CONFIG = {
        "XS": dict(input_clip_length=4, input_crop_size=160),
        "S": dict(input_clip_length=13, input_crop_size=160),
        "M": dict(input_clip_length=16, input_crop_size=224),
        "L": dict(input_clip_length=16, input_crop_size=312, depth_factor=5.0),
    }

    def __init__(self, expansion: str = "XS", num_classes: int = 400,
                 device: Union[str, torch.device] = "cuda", **kwargs):
        from pytorchvideo_tpu_torch.models.x3d import create_x3d

        if expansion not in self._EXPANSION_CONFIG:
            raise ValueError(f"expansion must be one of {list(self._EXPANSION_CONFIG)}, "
                             f"got {expansion!r}")
        config = {**self._EXPANSION_CONFIG[expansion], **kwargs}
        super().__init__(create_x3d(model_num_class=num_classes, device=device, **config))
        self.expansion = expansion
        self.config = config

    def convert(self, example_input=None, dtype: Optional[torch.dtype] = torch.bfloat16,
                fold_bn: bool = True) -> "EfficientX3d":
        """The deploy form: with ``example_input`` on a model on the card, a
        :class:`CompiledForward` at its shape; on a CPU model, or without an
        example, the eager deploy module."""
        # Imported here: the hub imports this module, and deploy.py the models.
        from pytorchvideo_tpu_torch.accelerate.deploy import convert_to_deployable_form

        on_card = next(self.model.parameters()).is_cuda
        example = example_input if on_card else None
        self._set_deploy(convert_to_deployable_form(self.model, dtype, example, fold_bn), dtype)
        return self

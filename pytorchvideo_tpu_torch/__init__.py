"""pytorchvideo_tpu_torch: the PyTorch/CUDA port of pytorchvideo_tpu.

A second package beside the JAX one, module for module (``layers``,
``models``, ``ops``, ``accelerate``, ``zoo``, ``losses``, ``transforms``,
``data``, ``train`` and ``engine`` mirror their JAX counterparts).
Models take NCTHW clips, as upstream pytorchvideo does (X3D runs in
``torch.channels_last_3d``; MViT's tokens are channels-last by layout), and
are built on the card unless the caller passes ``device="cpu"``. Each TPU
kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/``, built by ``nvcc`` at first use, with a plain PyTorch version
beside it that CPU tensors take. The package imports neither jax nor
pytorchvideo_tpu.
"""

__version__ = "0.1.0"

from pytorchvideo_tpu_torch import (  # noqa: F401
    accelerate,
    data,
    engine,
    layers,
    losses,
    models,
    ops,
    train,
    transforms,
    zoo,
)
from pytorchvideo_tpu_torch.models.hub.efficient_x3d import (  # noqa: F401
    efficient_x3d_s,
    efficient_x3d_xs,
)

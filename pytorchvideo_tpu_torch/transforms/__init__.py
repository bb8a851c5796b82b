"""Transforms of the port (counterpart of pytorchvideo_tpu/transforms): so
far the batch-level MixUp / CutMix of training and the one-hot labels they
need."""

from pytorchvideo_tpu_torch.transforms.functional import convert_to_one_hot  # noqa: F401
from pytorchvideo_tpu_torch.transforms.mix import CutMix, MixUp, MixVideo, cutmix, mixup  # noqa: F401

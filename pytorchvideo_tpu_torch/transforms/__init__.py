"""Transforms of the port (counterpart of pytorchvideo_tpu/transforms): the
video transforms and their classes, RandAugment and AugMix, the factory
chains, and the batch-level MixUp / CutMix of training. Clips are (T, H,
W, C) tensors on any device."""

from pytorchvideo_tpu_torch.transforms.augmentations import AugmentTransform  # noqa: F401
from pytorchvideo_tpu_torch.transforms.augmix import AugMix  # noqa: F401
from pytorchvideo_tpu_torch.transforms.functional import convert_to_one_hot  # noqa: F401
from pytorchvideo_tpu_torch.transforms.mix import CutMix, MixUp, MixVideo, cutmix, mixup  # noqa: F401
from pytorchvideo_tpu_torch.transforms.rand_augment import RandAugment  # noqa: F401
from pytorchvideo_tpu_torch.transforms.transforms import (  # noqa: F401
    ApplyTransformToKey,
    CenterCropVideo,
    Compose,
    ConvertFloatToUint8,
    ConvertUint8ToFloat,
    Div255,
    MoveChannelFront,
    MoveChannelRear,
    Normalize,
    OpSampler,
    Permute,
    RandomCropVideo,
    RandomHorizontalFlipVideo,
    RandomResizedCrop,
    RandomShortSideScale,
    RemoveKey,
    ShortSideScale,
    UniformCropVideo,
    UniformTemporalSubsample,
    UniformTemporalSubsampleRepeated,
)
from pytorchvideo_tpu_torch.transforms.transforms_factory import (  # noqa: F401
    create_video_transform,
)

"""EPIC-Kitchens: the manifest-driven dataset and its manifest builders
(counterpart of pytorchvideo_tpu/data/epic_kitchen)."""

from pytorchvideo_tpu_torch.data.epic_kitchen.epic_kitchen_dataset import (  # noqa: F401
    ActionData,
    EpicKitchenDataset,
)
from pytorchvideo_tpu_torch.data.epic_kitchen.utils import (  # noqa: F401
    build_encoded_manifest_from_nested_directory,
    build_frame_manifest_from_flat_directory,
    build_frame_manifest_from_nested_directory,
)

"""Ego4d moments: the dataset, its IMU reader, its audio front end and its
clip sampler (counterpart of pytorchvideo_tpu/data/ego4d)."""

from pytorchvideo_tpu_torch.data.ego4d.ego4d_dataset import (  # noqa: F401
    Ego4dImuData,
    Ego4dMomentsDataset,
    signal_transform,
)
from pytorchvideo_tpu_torch.data.ego4d.utils import (  # noqa: F401
    Ego4dImuDataBase,
    MomentsClipSampler,
    check_window_len,
    get_label_id_map,
)

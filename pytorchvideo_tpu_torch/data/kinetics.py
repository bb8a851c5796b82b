"""The Kinetics dataset: ``labeled_video_dataset`` under the dataset's name
(counterpart of pytorchvideo_tpu/data/kinetics.py; upstream pytorchvideo/data/kinetics.py:17)."""

from pytorchvideo_tpu_torch.data.labeled_video_dataset import labeled_video_dataset

Kinetics = labeled_video_dataset

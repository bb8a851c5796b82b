"""The UCF101 dataset: ``labeled_video_dataset`` under the dataset's name
(counterpart of pytorchvideo_tpu/data/ucf101.py; upstream pytorchvideo/data/ucf101.py:17)."""

from pytorchvideo_tpu_torch.data.labeled_video_dataset import labeled_video_dataset

Ucf101 = labeled_video_dataset

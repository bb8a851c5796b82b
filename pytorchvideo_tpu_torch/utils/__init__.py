"""Model complexity and profiling helpers (counterpart of pytorchvideo_tpu/utils)."""

from pytorchvideo_tpu_torch.utils.profiling import annotate, time_jitted, trace  # noqa: F401

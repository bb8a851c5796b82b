"""Kernels of the port, each beside its plain PyTorch version.

The package exports the JAX package's names: ``ops.pooled_attention`` is the
attention function, as there, so the module of that name is reached by
``from pytorchvideo_tpu_torch.ops.pooled_attention import ...`` or
``importlib.import_module``."""

from pytorchvideo_tpu_torch.ops.depthwise_conv import (  # noqa: F401
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
    depthwise3x3x3_bn_swish_torch,
)
from pytorchvideo_tpu_torch.ops.pooled_attention import (  # noqa: F401
    pooled_attention,
    pooled_attention_packed,
)
from pytorchvideo_tpu_torch.ops.roi_align import RoIAlign, roi_align  # noqa: F401
from pytorchvideo_tpu_torch.ops.token_pool import (  # noqa: F401
    avg_token_pool,
    depthwise_token_pool,
    max_token_pool,
)

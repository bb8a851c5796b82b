"""Deploy-time rewrites (counterpart of pytorchvideo_tpu/accelerate)."""

from pytorchvideo_tpu_torch.accelerate.deploy import (  # noqa: F401
    CompiledForward,
    DepthwiseConv3x3x3BnAct,
    convert_to_deployable_form,
    export_program,
)
from pytorchvideo_tpu_torch.accelerate.fuse import fold_conv_bn  # noqa: F401

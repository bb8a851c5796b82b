"""Deploy-time rewrites (counterpart of pytorchvideo_tpu/accelerate).

Every name the JAX package's ``accelerate`` exports, but two that keep their
existing counterparts: ``cast_variables`` is the deploy form's cast
(``deploy.cast_pass``, the ``dtype`` of ``convert_to_deployable_form``), and
``export_stablehlo`` is :func:`export_program` (``torch.export``).
"""

from pytorchvideo_tpu_torch.accelerate.deploy import (  # noqa: F401
    CompiledForward,
    DepthwiseConv3x3x3BnAct,
    convert_to_deployable_form,
    export_program,
)
from pytorchvideo_tpu_torch.accelerate.conv_blocks import (  # noqa: F401
    AdaptiveAvgPool2d,
    AdaptiveAvgPool2dOutSize1,
    AdaptiveAvgPool3d,
    AdaptiveAvgPool3dOutSize1,
    Conv3d3x1x1BnAct,
    Conv3d3x3x3DwBnAct,
    Conv3d5x1x1BnAct,
    Conv3dPwBnAct,
    Conv3dTemporalKernel1BnAct,
    FullyConnected,
    HardSwish,
    Identity,
    ReLU,
    SqueezeExcitation,
    Swish,
    X3dBottleneckBlock,
    supported_act_functions,
)
from pytorchvideo_tpu_torch.accelerate.efficient_blocks import (  # noqa: F401
    EfficientBlockBase,
    EfficientX3d,
    NoOpConvertBlock,
)
from pytorchvideo_tpu_torch.accelerate.fuse import fold_conv_bn, fuse_bn_mvit  # noqa: F401
from pytorchvideo_tpu_torch.accelerate.int8 import (  # noqa: F401
    int8_serving_fn,
    make_int8_interceptor,
    prepare_int8_weights,
)
from pytorchvideo_tpu_torch.accelerate.quantize import (  # noqa: F401
    dequantize_variables,
    quantization_error,
    quantize_variables,
)
from pytorchvideo_tpu_torch.accelerate.transmuter import (  # noqa: F401
    EFFICIENT_BLOCK_TRANSMUTER_REGISTRY,
    register_transmuter,
    transmute_model,
)

"""Layers of the port (counterpart of pytorchvideo_tpu/layers)."""

from pytorchvideo_tpu_torch.layers.attention import (  # noqa: F401
    Mlp,
    MultiScaleAttention,
    MultiScaleBlock,
    TokenPool,
    scaled_dot_product_attention,
)
from pytorchvideo_tpu_torch.layers.common import (  # noqa: F401
    Conv3d,
    adaptive_avg_pool3d_to_1,
    avg_pool3d,
    max_pool3d,
)
from pytorchvideo_tpu_torch.layers.convolutions import (  # noqa: F401
    Conv2plus1d,
    ConvReduce3D,
    create_conv_2plus1d,
)
from pytorchvideo_tpu_torch.layers.fusion import (  # noqa: F401
    ConcatFusion,
    ReduceFusion,
    TemporalConcatFusion,
    make_fusion_layer,
)
from pytorchvideo_tpu_torch.layers.mlp import (  # noqa: F401
    MultilayerPerceptron,
    make_multilayer_perceptron,
)
from pytorchvideo_tpu_torch.layers.nonlocal_net import NonLocal, create_nonlocal  # noqa: F401
from pytorchvideo_tpu_torch.layers.batch_norm import (  # noqa: F401
    BatchNorm3d,
    NaiveSyncBatchNorm1d,
    NaiveSyncBatchNorm2d,
    NaiveSyncBatchNorm3d,
    set_sync_group,
)
from pytorchvideo_tpu_torch.layers.norms import (  # noqa: F401
    BatchNorm,
    BatchNorm1d,
    BatchNorm2d,
    Identity,
    LayerNorm,
    make_act,
    make_norm,
)
from pytorchvideo_tpu_torch.layers.pooling import (  # noqa: F401
    AdaptiveAvgPool3d,
    AvgPool3d,
    MaxPool3d,
)
from pytorchvideo_tpu_torch.layers.positional_encoding import (  # noqa: F401
    PositionalEncoding,
    SpatioTemporalClsPositionalEncoding,
    get_1d_sincos_pos_embed_from_grid,
    get_2d_sincos_pos_embed,
    get_2d_sincos_pos_embed_from_grid,
    get_3d_sincos_pos_embed,
)
from pytorchvideo_tpu_torch.layers.squeeze_excitation import (  # noqa: F401
    SqueezeAndExcitationLayer2D,
    SqueezeExcitation,
    SqueezeExcitation2d,
    create_audio_2d_squeeze_excitation_block,
)
from pytorchvideo_tpu_torch.layers.stochastic import (  # noqa: F401
    DropPath,
    Swish,
    drop_path,
    drop_path_pair,
    swish,
)
from pytorchvideo_tpu_torch.layers.utils import round_repeats, round_width  # noqa: F401

"""Models of the port (counterpart of pytorchvideo_tpu/models)."""

from pytorchvideo_tpu_torch.models import hub  # noqa: F401
from pytorchvideo_tpu_torch.models.audio_visual_slowfast import (  # noqa: F401
    AudioToSlowFastFusionBuilder,
    FuseAudioToFastSlow,
    create_audio_visual_slowfast,
)
from pytorchvideo_tpu_torch.models.byol import BYOL  # noqa: F401
from pytorchvideo_tpu_torch.models.csn import create_csn  # noqa: F401
from pytorchvideo_tpu_torch.models.detection import (  # noqa: F401
    ResNetRoIHead,
    create_res_roi_pooling_head,
    create_resnet_with_roi_head,
    create_slowfast_with_roi_head,
)
from pytorchvideo_tpu_torch.models.head import (  # noqa: F401
    ResNetBasicHead,
    SequencePool,
    VisionTransformerBasicHead,
    create_res_basic_head,
    create_vit_basic_head,
)
from pytorchvideo_tpu_torch.models.masked_multistream import (  # noqa: F401
    LSTM,
    LearnMaskedDefault,
    MaskedMultiPathWay,
    MaskedSequential,
    MaskedTemporalPooling,
    TransposeMultiheadAttention,
    TransposeTransformerEncoder,
)
from pytorchvideo_tpu_torch.models.memory_bank import MemoryBank  # noqa: F401
from pytorchvideo_tpu_torch.models.net import (  # noqa: F401
    DetectionBBoxNetwork,
    MultiPathWayWithFuse,
    Net,
)
from pytorchvideo_tpu_torch.models.r2plus1d import (  # noqa: F401
    create_2plus1d_bottleneck_block,
    create_r2plus1d,
)
from pytorchvideo_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResBlock,
    ResStage,
    SeparableBottleneckBlock,
    create_acoustic_bottleneck_block,
    create_acoustic_resnet,
    create_bottleneck_block,
    create_res_block,
    create_res_stage,
    create_resnet,
)
from pytorchvideo_tpu_torch.models.simclr import SimCLR  # noqa: F401
from pytorchvideo_tpu_torch.models.slowfast import (  # noqa: F401
    FastToSlowFusionBuilder,
    FuseFastToSlow,
    PoolConcatPathway,
    create_slowfast,
)
from pytorchvideo_tpu_torch.models.stem import (  # noqa: F401
    PatchEmbed,
    ResNetBasicStem,
    create_acoustic_res_basic_stem,
    create_conv_patch_embed,
    create_res_basic_stem,
)
from pytorchvideo_tpu_torch.models.vision_transformers import (  # noqa: F401
    MultiscaleVisionTransformers,
    create_multiscale_vision_transformers,
)
from pytorchvideo_tpu_torch.models.weight_init import (  # noqa: F401
    init_net_weights,
    init_resnet_weights,
    init_vit_weights,
)
from pytorchvideo_tpu_torch.models.x3d import (  # noqa: F401
    ProjectedPool,
    create_x3d,
    create_x3d_bottleneck_block,
    create_x3d_head,
    create_x3d_res_block,
    create_x3d_res_stage,
    create_x3d_stem,
)

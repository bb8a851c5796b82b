from pytorchvideo_tpu_torch.models.hub.csn import csn_r101  # noqa: F401
from pytorchvideo_tpu_torch.models.hub.efficient_x3d import efficient_x3d_s, efficient_x3d_xs  # noqa: F401
from pytorchvideo_tpu_torch.models.hub.r2plus1d import r2plus1d_r50  # noqa: F401
from pytorchvideo_tpu_torch.models.hub.resnet import (  # noqa: F401
    c2d_r50,
    i3d_r50,
    slow_r50,
    slow_r50_detection,
)
from pytorchvideo_tpu_torch.models.hub.slowfast import (  # noqa: F401
    slowfast_16x8_r101_50_50,
    slowfast_r50,
    slowfast_r50_detection,
    slowfast_r101,
)
from pytorchvideo_tpu_torch.models.hub.utils import (  # noqa: F401
    MODEL_ZOO_ROOT_DIR,
    hub_model_builder,
    load_pretrained_variables,
)
from pytorchvideo_tpu_torch.models.hub.vision_transformers import (  # noqa: F401
    mvit_base_16,
    mvit_base_16x4,
    mvit_base_32x3,
)
from pytorchvideo_tpu_torch.models.hub.x3d import x3d_l, x3d_m, x3d_s, x3d_xs  # noqa: F401

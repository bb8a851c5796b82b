"""Named ResNet architectures (counterpart of pytorchvideo_tpu/models/hub/resnet.py,
upstream models/hub/resnet.py:41-159). Weights are the builder's own random
init; ``hub.utils.load_pretrained_variables`` loads a local ``.pyth``. Each
factory takes its builder's keywords, ``device`` included ("cuda" unless the
caller asks for the CPU). The classifiers take 8x224x224 NCTHW clips,
``slow_r50_detection`` 4x256x256 clips and (N, 5) boxes."""

from pytorchvideo_tpu_torch.layers.pooling import MaxPool3d
from pytorchvideo_tpu_torch.models.detection import create_resnet_with_roi_head
from pytorchvideo_tpu_torch.models.resnet import create_resnet

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {
    "slow_r50": "kinetics/SLOW_8x8_R50.pyth",
    "c2d_r50": "kinetics/C2D_8x8_R50.pyth",
    "i3d_r50": "kinetics/I3D_8x8_R50.pyth",
}


def slow_r50(**kwargs):
    """Slow R50 8x8."""
    kwargs.setdefault("stem_conv_kernel_size", (1, 7, 7))
    kwargs.setdefault("head_pool_kernel_size", (8, 7, 7))
    kwargs.setdefault("model_depth", 50)
    return create_resnet(**kwargs)


def c2d_r50(**kwargs):
    """C2D R50 8x8: 2-D convs, a temporal max pool after stage 1."""
    kwargs.setdefault("stem_conv_kernel_size", (1, 7, 7))
    kwargs.setdefault("stage1_pool", MaxPool3d)
    kwargs.setdefault("stage_conv_a_kernel_size", ((1, 1, 1),) * 4)
    return create_resnet(**kwargs)


def i3d_r50(**kwargs):
    """I3D R50 8x8: conv_a kernels that alternate per block."""
    kwargs.setdefault("stem_conv_kernel_size", (5, 7, 7))
    kwargs.setdefault("stage1_pool", MaxPool3d)
    kwargs.setdefault(
        "stage_conv_a_kernel_size",
        (
            (3, 1, 1),
            [(3, 1, 1), (1, 1, 1)],
            [(3, 1, 1), (1, 1, 1)],
            [(1, 1, 1), (3, 1, 1)],
        ),
    )
    return create_resnet(**kwargs)


def slow_r50_detection(**kwargs):
    """Slow R50 4x16 AVA detector (upstream hub/resnet.py:73-90; checkpoint
    ava/SLOW_4x16_R50_DETECTION.pyth): 80 classes, res5 dilated at stride
    1, RoI head at spatial scale 1/16."""
    return create_resnet_with_roi_head(**kwargs)

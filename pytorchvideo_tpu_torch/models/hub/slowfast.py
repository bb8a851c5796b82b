"""Named SlowFast architectures (counterpart of pytorchvideo_tpu/models/hub/slowfast.py,
upstream models/hub/slowfast.py:37-148). Weights are the builder's own
random init. Each factory takes ``create_slowfast``'s keywords, ``device``
included ("cuda" unless the caller asks for the CPU), and takes
``[slow, fast]`` NCTHW clips. The JAX factories default to the packed fast
pathway (``pathway_packs=(1, 2)``), a TPU layout with the plain build's
parameters; the port's build is the plain one, as is the JAX
``slowfast_r50_detection``'s."""

from pytorchvideo_tpu_torch.models.detection import create_slowfast_with_roi_head
from pytorchvideo_tpu_torch.models.slowfast import create_slowfast

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {
    "slowfast_r50": "kinetics/SLOWFAST_8x8_R50.pyth",
    "slowfast_r101": "kinetics/SLOWFAST_8x8_R101.pyth",
    "slowfast_16x8_r101_50_50": "kinetics/SLOWFAST_16x8_R101_50_50.pyth",
}


def slowfast_r50(**kwargs):
    """SlowFast R50 8x8 (8- and 32-frame 224x224 clips)."""
    kwargs.setdefault("model_depth", 50)
    kwargs.setdefault("slowfast_fusion_conv_kernel_size", (7, 1, 1))
    return create_slowfast(**kwargs)


def slowfast_r101(**kwargs):
    """SlowFast R101 8x8 (8- and 32-frame 224x224 clips)."""
    kwargs.setdefault("model_depth", 101)
    kwargs.setdefault("slowfast_fusion_conv_kernel_size", (5, 1, 1))
    return create_slowfast(**kwargs)


def slowfast_16x8_r101_50_50(**kwargs):
    """SlowFast R101_50_50 16x8 (16- and 64-frame 224x224 clips): stage 3
    has 6 temporal conv_a blocks, then pointwise ones."""
    stage3 = ((3, 1, 1),) * 6 + ((1, 1, 1),) * (23 - 6)
    kwargs.setdefault("model_depth", 101)
    kwargs.setdefault("slowfast_fusion_conv_kernel_size", (5, 1, 1))
    kwargs.setdefault("stage_conv_a_kernel_sizes", (
        ((1, 1, 1), (1, 1, 1), stage3, (3, 1, 1)),
        ((3, 1, 1), (3, 1, 1), stage3, (3, 1, 1)),
    ))
    kwargs.setdefault("head_pool_kernel_sizes", ((16, 7, 7), (64, 7, 7)))
    return create_slowfast(**kwargs)


def slowfast_r50_detection(**kwargs):
    """SlowFast R50 8x8 AVA detector (upstream hub/slowfast.py:150-176;
    checkpoint ava/SLOWFAST_8x8_R50_DETECTION.pyth): 80 classes, res5
    dilated at stride 1, RoI head at spatial scale 1/16; [8, 32] x 256 x 256
    clips and (N, 5) boxes."""
    return create_slowfast_with_roi_head(**kwargs)

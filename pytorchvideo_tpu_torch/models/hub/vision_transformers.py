"""Named MViT architectures (counterpart of
pytorchvideo_tpu/models/hub/vision_transformers.py, upstream
models/hub/vision_transformers.py:13-59). Weights are the builder's own random
init: the port loads no checkpoint yet. Each factory takes the builder's
keywords, ``device`` included ("cuda" unless the caller asks for the CPU)."""

from pytorchvideo_tpu_torch.models.vision_transformers import (
    create_multiscale_vision_transformers,
)

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {
    "mvit_base_16x4": "kinetics/MVIT_B_16x4.pyth",
    "mvit_base_32x3": "kinetics/MVIT_B_32x3_f294077834.pyth",
    "mvit_base_16": "imagenet/MVIT_B_16_f292487636.pyth",
}

mvit_video_base_config = {
    "spatial_size": 224,
    "temporal_size": 16,
    "embed_dim_mul": [[1, 2.0], [3, 2.0], [14, 2.0]],
    "atten_head_mul": [[1, 2.0], [3, 2.0], [14, 2.0]],
    "pool_q_stride_size": [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]],
    "pool_kv_stride_adaptive": [1, 8, 8],
    "pool_kvq_kernel": [3, 3, 3],
}

mvit_video_base_32x3_config = dict(mvit_video_base_config, temporal_size=32)

mvit_image_base_16_config = {
    "spatial_size": 224,
    "temporal_size": 1,
    "depth": 16,
    "conv_patch_embed_kernel": [7, 7],
    "conv_patch_embed_stride": [4, 4],
    "conv_patch_embed_padding": [3, 3],
    "use_2d_patch": True,
    "embed_dim_mul": [[1, 2.0], [3, 2.0], [14, 2.0]],
    "atten_head_mul": [[1, 2.0], [3, 2.0], [14, 2.0]],
    "pool_q_stride_size": [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]],
    "pool_kv_stride_adaptive": [1, 4, 4],
    "pool_kvq_kernel": [1, 3, 3],
}


def mvit_base_16x4(**kwargs):
    """MViT-B 16x4 (16x224x224 clips)."""
    return create_multiscale_vision_transformers(**{**mvit_video_base_config, **kwargs})


def mvit_base_32x3(**kwargs):
    """MViT-B 32x3 (32x224x224 clips)."""
    return create_multiscale_vision_transformers(**{**mvit_video_base_32x3_config, **kwargs})


def mvit_base_16(**kwargs):
    """MViT-B 16 (ImageNet: 1x224x224 clips, 2-D patches)."""
    return create_multiscale_vision_transformers(**{**mvit_image_base_16_config, **kwargs})

"""Named X3D architectures (counterpart of pytorchvideo_tpu/models/hub/x3d.py,
upstream models/hub/x3d.py:36-163). Weights are the builders' own random
init: the port loads no checkpoint yet. Each factory takes ``create_x3d``'s
keywords, ``device`` included ("cuda" unless the caller asks for the CPU)."""

from pytorchvideo_tpu_torch.models.x3d import create_x3d

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {
    "x3d_xs": "kinetics/X3D_XS.pyth",
    "x3d_s": "kinetics/X3D_S.pyth",
    "x3d_m": "kinetics/X3D_M.pyth",
    "x3d_l": "kinetics/X3D_L.pyth",
}


def x3d_xs(**kwargs):
    """X3D-XS 4x160."""
    kwargs.setdefault("input_clip_length", 4)
    kwargs.setdefault("input_crop_size", 160)
    return create_x3d(**kwargs)


def x3d_s(**kwargs):
    """X3D-S 13x160."""
    kwargs.setdefault("input_clip_length", 13)
    kwargs.setdefault("input_crop_size", 160)
    return create_x3d(**kwargs)


def x3d_m(**kwargs):
    """X3D-M 16x224."""
    kwargs.setdefault("input_clip_length", 16)
    kwargs.setdefault("input_crop_size", 224)
    return create_x3d(**kwargs)


def x3d_l(**kwargs):
    """X3D-L 16x312, depth_factor 5.0."""
    kwargs.setdefault("input_clip_length", 16)
    kwargs.setdefault("input_crop_size", 312)
    kwargs.setdefault("depth_factor", 5.0)
    return create_x3d(**kwargs)

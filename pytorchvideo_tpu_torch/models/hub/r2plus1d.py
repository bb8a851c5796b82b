"""Named R(2+1)D architecture (counterpart of pytorchvideo_tpu/models/hub/r2plus1d.py,
upstream models/hub/r2plus1d.py:20-55). Weights are the builder's own random
init. The factory takes ``create_r2plus1d``'s keywords, ``device`` included
("cuda" unless the caller asks for the CPU)."""

from pytorchvideo_tpu_torch.models.r2plus1d import create_r2plus1d

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {"r2plus1d_r50": "kinetics/R2PLUS1D_16x4_R50.pyth"}


def r2plus1d_r50(**kwargs):
    """R(2+1)D R50 16x4 (16-frame 224x224 clips)."""
    kwargs.setdefault("dropout_rate", 0.5)
    return create_r2plus1d(**kwargs)

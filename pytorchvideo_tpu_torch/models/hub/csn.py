"""Named CSN architecture (counterpart of pytorchvideo_tpu/models/hub/csn.py,
upstream models/hub/csn.py:20-52). Weights are the builder's own random
init. The factory takes ``create_csn``'s keywords, ``device`` included
("cuda" unless the caller asks for the CPU)."""

from pytorchvideo_tpu_torch.models.csn import create_csn

# Upstream's checkpoint file names (names only: nothing is downloaded).
checkpoint_names = {"csn_r101": "kinetics/CSN_32x2_R101.pyth"}


def csn_r101(**kwargs):
    """CSN R101 32x2 (32-frame 224x224 clips). As in the JAX package there
    is no stem pool, so stage 1 runs at 112x112 and the (4, 7, 7) head pool
    sees 4x14x14 before the global average."""
    kwargs.setdefault("model_depth", 101)
    kwargs.setdefault("head_pool_kernel_size", (4, 7, 7))
    return create_csn(**kwargs)

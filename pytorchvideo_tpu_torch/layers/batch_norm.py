"""NaiveSyncBatchNorm counterparts (of pytorchvideo_tpu/layers/batch_norm.py;
upstream pytorchvideo/layers/batch_norm.py:45-226, its local groups
GroupGather in layers/distributed.py:91-145).

Upstream all-reduces each rank's mean and mean of squares by hand; the JAX
package's BatchNorm takes ``axis_name`` and ``axis_index_groups``; the
port's :class:`~pytorchvideo_tpu_torch.layers.norms.BatchNorm` takes a
``process_group``: the world's, or one of
``parallel.new_local_sync_groups`` for upstream's ``num_sync_devices``.
The builders make their norms without one; :func:`set_sync_group` gives a
built model's norms theirs.
"""

from __future__ import annotations

import torch.nn as nn

from pytorchvideo_tpu_torch.layers.norms import (  # noqa: F401
    BatchNorm,
    BatchNorm1d,
    BatchNorm2d,
)

BatchNorm3d = BatchNorm
# One class syncs or not by its process group, as the JAX package's one
# BatchNorm does by its axis name.
NaiveSyncBatchNorm1d = BatchNorm1d
NaiveSyncBatchNorm2d = BatchNorm2d
NaiveSyncBatchNorm3d = BatchNorm


def set_sync_group(model: nn.Module, process_group) -> int:
    """Sets ``process_group`` (None: local statistics again) on every
    :class:`BatchNorm` of ``model``, the BatchNorm MViT's token norms
    included; returns how many."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = process_group
    return len(norms)

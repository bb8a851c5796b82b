"""Generic model containers (counterpart of pytorchvideo_tpu/models/net.py
``Net``, ``DetectionBBoxNetwork`` and ``MultiPathWayWithFuse``; upstream
models/net.py:11-44, :47-74, :77-122)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn


def _channels_last(x):
    if isinstance(x, (list, tuple)):
        return [_channels_last(p) for p in x]
    return x.contiguous(memory_format=torch.channels_last_3d)


class Net(nn.Module):
    """Sequential composition of stem, stages and head.

    Takes an NCTHW clip, or a list of them (one per pathway, SlowFast's
    ``[slow, fast]``), and runs the blocks in ``torch.channels_last_3d``, so
    that a (B, C, T, H, W) activation ``x`` has ``x.permute(0, 2, 3, 4, 1)``
    as a contiguous (B, T, H, W, C) view, the layout of the port's kernels.
    """

    def __init__(self, *, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: Union[torch.Tensor, List[torch.Tensor]]):
        x = _channels_last(x)
        for block in self.blocks:
            x = block(x)
        return x


class DetectionBBoxNetwork(nn.Module):
    """A backbone and a box head (upstream net.py:47-74): ``forward(x,
    bboxes)`` runs ``model`` on ``x`` (a clip, or SlowFast's pathway list)
    and ``detection_head`` on its features and ``bboxes``, (N, 5) rows of
    (batch index, x1, y1, x2, y2) in input pixels."""

    def __init__(self, *, model: nn.Module, detection_head: nn.Module):
        super().__init__()
        self.model = model
        self.detection_head = detection_head

    def forward(self, x: Union[torch.Tensor, List[torch.Tensor]],
                bboxes: torch.Tensor) -> torch.Tensor:
        return self.detection_head(self.model(x), bboxes)


class MultiPathWayWithFuse(nn.Module):
    """One block per pathway of a list input, then an optional fusion of the
    list (SlowFast's ``FuseFastToSlow`` returns a list, ``PoolConcatPathway``
    one tensor)."""

    def __init__(
        self,
        *,
        multipathway_blocks: Sequence[nn.Module],
        multipathway_fusion: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList(multipathway_blocks)
        self.multipathway_fusion = multipathway_fusion

    def forward(self, x: List[torch.Tensor]):
        if not isinstance(x, (list, tuple)) or len(x) != len(self.multipathway_blocks):
            raise ValueError(
                f"expected a list of {len(self.multipathway_blocks)} pathway tensors")
        out = [block(pathway) for block, pathway in zip(self.multipathway_blocks, x)]
        if self.multipathway_fusion is not None:
            out = self.multipathway_fusion(out)
        return out

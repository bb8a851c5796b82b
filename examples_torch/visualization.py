"""Video detection visualization: draw predicted boxes + class labels on
clip frames (numpy and OpenCV on the host; the port's own copy of
examples/visualization.py, drawing the same pixels).

Parity: upstream tutorials/video_detection_example/visualization.py
(ImgVisualizer text drawing :69-360, VideoVisualizer :362-640, which draw
with matplotlib). Here cv2 draws on THWC uint8 frames: numpy arrays, or
CPU tensors, which are read as arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _color_for(idx: int):
    rng = np.random.default_rng(idx * 7919 + 11)
    c = rng.integers(64, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


class VideoVisualizer:
    """Draw per-box top-k class scores on video frames
    (upstream VideoVisualizer :362; thres/top-k semantics preserved)."""

    def __init__(
        self,
        num_classes: int,
        class_names: Optional[Dict[int, str]] = None,
        top_k: int = 1,
        thres: float = 0.7,
    ):
        self.num_classes = num_classes
        self.class_names = class_names or {}
        self.top_k = top_k
        self.thres = thres

    def _labels(self, scores: np.ndarray) -> List[str]:
        order = np.argsort(-scores)[: self.top_k]
        out = []
        for c in order:
            if scores[c] < self.thres:
                continue
            name = self.class_names.get(int(c), str(int(c)))
            out.append(f"{name}: {scores[c]:.2f}")
        return out

    def draw_one_frame(
        self,
        frame: np.ndarray,
        boxes: np.ndarray,
        scores: np.ndarray,
    ) -> np.ndarray:
        """frame: (H, W, 3) uint8; boxes: (N, 4) xyxy; scores: (N, C)."""
        import cv2

        img = np.ascontiguousarray(np.asarray(frame)).copy()
        for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
            x0, y0, x1, y1 = [int(round(v)) for v in box]
            color = _color_for(i)
            cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)
            for j, text in enumerate(self._labels(np.asarray(scores[i]))):
                cv2.putText(
                    img,
                    text,
                    (x0 + 2, max(12, y0 + 14 + 14 * j)),
                    cv2.FONT_HERSHEY_SIMPLEX,
                    0.45,
                    color,
                    1,
                    cv2.LINE_AA,
                )
        return img

    def draw_clip(
        self,
        clip: np.ndarray,
        boxes: np.ndarray,
        scores: np.ndarray,
        repeat_frame: int = 1,
    ) -> np.ndarray:
        """clip: (T, H, W, 3) uint8 -> annotated (T*repeat, H, W, 3)
        (upstream draw_clip_range :531 keyframe-repeat behavior)."""
        frames = [
            self.draw_one_frame(f, boxes, scores)
            for f in np.asarray(clip)
            for _ in range(repeat_frame)
        ]
        return np.stack(frames)

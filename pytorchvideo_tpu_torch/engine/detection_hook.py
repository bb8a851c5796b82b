"""Detection hooks for the NeuralEngine (counterpart of
pytorchvideo_tpu/engine/detection_hook.py; upstream
pytorchvideo/neural_engine/detection_hook.py: ImageLoadHook :89,
Detectron2PeopleDetectionHook :120, PeopleKeypointDetectionHook :48).

As in the JAX package, the person detector is a predictor: any callable
from an (H, W, C) uint8 RGB frame to a dict with "boxes" (N, 4) xyxy,
"labels" and "scores" (and "keypoints"), or, for :class:`PeopleDetectionHook`,
to the (N, 4) person boxes themselves. ``generate_predictor`` builds one from
torchvision's detection zoo. OpenCV and torchvision are imported only where
they are used: the card's machine has neither, so there a pipeline takes a
decoded video and an injected predictor. :class:`ActionDetectionHook` then
scores each box with the port's RoI-head detectors (models/detection.py).
"""

from __future__ import annotations

import warnings
from typing import Callable, Mapping, MutableMapping, Optional, Union

import numpy as np
import torch

from pytorchvideo_tpu_torch.engine.hook import HookBase, transform_on
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.models.net import MultiPathWayWithFuse
from pytorchvideo_tpu_torch.transforms import (
    Compose,
    Div255,
    Normalize,
    ShortSideScale,
    UniformTemporalSubsample,
)
from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw


def _require(module: str, purpose: str):
    """Imports ``module`` or raises an ImportError that names it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{purpose} needs the {module!r} package, which is not installed"
                          ) from e


def image_load_executor(image_path: str) -> torch.Tensor:
    """One image file as an (H, W, C) uint8 RGB tensor (upstream
    detection_hook.py:84-86 reads BGR with cv2.imread)."""
    cv2 = _require("cv2", "image_load_executor")
    arr = cv2.imread(image_path)
    if arr is None:
        raise IOError(f"failed to read image: {image_path}")
    return torch.from_numpy(cv2.cvtColor(arr, cv2.COLOR_BGR2RGB))


class ImageLoadHook(HookBase):
    """image_path -> loaded_image (upstream detection_hook.py:89-99)."""

    def __init__(self, executor: Callable = image_load_executor):
        super().__init__(executor=executor, inputs=["image_path"], outputs=["loaded_image"])

    def _run(self, status: MutableMapping) -> dict:
        return {"loaded_image": self.executor(status["image_path"])}


#: The default keypoint model (upstream detection_hook.py:20-24), from
#: torchvision's zoo, whose COCO person label is 1 (detectron2's is 0).
model_config = {
    "backend": "torchvision",
    "model": "keypointrcnn_resnet50_fpn",
    "threshold": 0.7,
}


def generate_predictor(model_config: dict, device: Union[str, torch.device] = "cuda"):
    """A predictor from torchvision's detection zoo (upstream
    detection_hook.py:27-42 builds a detectron2 ``DefaultPredictor``):
    ``image (H, W, C) uint8 RGB -> {"boxes", "scores", "labels",
    ["keypoints"]}`` on ``device``, the detections under
    ``model_config["threshold"]`` dropped.

    The weights are ``model_config["state_dict"]`` where it is given (a
    state dict, or the path of one saved by ``torch.save``), loaded
    strictly; else torchvision's ``model_config.get("weights", "DEFAULT")``.
    Weights that torchvision cannot fetch (no network and nothing in its
    cache) raise RuntimeError; only an explicit ``"weights": None`` builds a
    randomly initialised detector, with a warning, since its boxes mean
    nothing. (The JAX function falls back to the random init silently.)
    Another backend raises ValueError; a machine without torchvision raises
    ImportError."""
    if model_config["backend"] != "torchvision":
        raise ValueError(f"unsupported backend {model_config['backend']!r}; inject a predictor "
                         "callable instead")
    detection = _require("torchvision", "generate_predictor").models.detection
    name = model_config["model"]
    builder = getattr(detection, name)
    state_dict = model_config.get("state_dict")
    weights = model_config.get("weights", "DEFAULT")
    if state_dict is not None:
        net = builder(weights=None, weights_backbone=None)
        if not isinstance(state_dict, Mapping):
            state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
        net.load_state_dict(state_dict)
    elif weights is None:
        warnings.warn(f"generate_predictor: {name} with weights=None is randomly initialised; "
                      "its detections mean nothing", stacklevel=2)
        net = builder(weights=None, weights_backbone=None)
    else:
        try:
            net = builder(weights=weights)
        except OSError as e:  # the download failed
            raise RuntimeError(
                f"generate_predictor: torchvision cannot fetch the {weights!r} weights of "
                f"{name} ({e}); give model_config['state_dict'] (a local checkpoint), or "
                "'weights': None for a random init") from e
    net = net.to(device).eval()
    threshold = float(model_config.get("threshold", 0.7))

    def predictor(image) -> dict:
        with torch.inference_mode():
            frame = torch.as_tensor(image).to(device).permute(2, 0, 1).float() / 255.0
            out = net([frame])[0]
        keep = out["scores"] >= threshold
        return {k: v[keep] for k, v in out.items()}

    return predictor


def people_detection_executor(loaded_image, predictor: Callable) -> torch.Tensor:
    """The predictor's person boxes, (N, 4) xyxy float32 (upstream
    detection_hook.py:102-110; torchvision's COCO person label is 1)."""
    out = predictor(loaded_image)
    person = torch.as_tensor(out["labels"]) == 1
    boxes = torch.as_tensor(out["boxes"], dtype=torch.float32)
    return boxes[person.to(boxes.device)].reshape(-1, 4)


def people_keypoints_executor(loaded_image, predictor: Callable) -> torch.Tensor:
    """The predictor's person keypoints, (N, K, 3) (x, y, score) float32
    (upstream detection_hook.py:45-46, :75-81)."""
    out = predictor(loaded_image)
    person = torch.as_tensor(out["labels"]) == 1
    keypoints = torch.as_tensor(out["keypoints"], dtype=torch.float32)
    return keypoints[person.to(keypoints.device)]


class Detectron2PeopleDetectionHook(HookBase):
    """loaded_image -> bbox_coordinates with a predictor from
    :func:`generate_predictor` (upstream detection_hook.py:120-151; the name
    is upstream's, the backend torchvision)."""

    def __init__(
        self,
        model_config: Optional[dict] = None,
        executor: Callable = people_detection_executor,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(inputs=["loaded_image"], outputs=["bbox_coordinates"],
                         fail_strategy=fail_strategy, priority=priority)
        self.model_config = model_config or {
            "backend": "torchvision",
            "model": "fasterrcnn_resnet50_fpn",
            "threshold": 0.7,
        }
        self.executor = executor
        self.predictor = generate_predictor(self.model_config, device)

    def _run(self, status: MutableMapping) -> dict:
        return {"bbox_coordinates": self.executor(status["loaded_image"], self.predictor)}


class PeopleKeypointDetectionHook(HookBase):
    """(loaded_image, bbox_coordinates) -> keypoint_coordinates (upstream
    detection_hook.py:48-81)."""

    def __init__(
        self,
        model_config: dict = model_config,
        executor: Callable = people_keypoints_executor,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(inputs=["loaded_image", "bbox_coordinates"],
                         outputs=["keypoint_coordinates"], fail_strategy=fail_strategy,
                         priority=priority)
        self.model_config = model_config
        self.executor = executor
        self.predictor = generate_predictor(model_config, device)

    def _run(self, status: MutableMapping) -> dict:
        return {"keypoint_coordinates": self.executor(status["loaded_image"], self.predictor)}


def full_frame_person_boxes(loaded_image) -> torch.Tensor:
    """A predictor with one box over the whole frame: the pipeline runs
    without a person detector."""
    h, w = loaded_image.shape[:2]
    return torch.tensor([[0.0, 0.0, float(w), float(h)]])


class PeopleDetectionHook(HookBase):
    """loaded_image -> bbox_coordinates, (N, 4) xyxy float32 from an injected
    ``predictor`` (default :func:`full_frame_person_boxes`), the JAX
    package's stand-in for upstream's detectron2 hook."""

    def __init__(
        self,
        predictor: Optional[Callable] = None,
        threshold: float = 0.7,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
    ):
        super().__init__(inputs=["loaded_image"], outputs=["bbox_coordinates"],
                         fail_strategy=fail_strategy, priority=priority)
        self.predictor = predictor or full_frame_person_boxes
        self.threshold = threshold

    def _run(self, status: MutableMapping) -> dict:
        boxes = torch.as_tensor(self.predictor(status["loaded_image"]), dtype=torch.float32)
        return {"bbox_coordinates": boxes.reshape(-1, 4)}


class ActionDetectionHook(HookBase):
    """(video, bbox_coordinates) -> action_scores: the scores of a hub
    RoI-head detector for each box, (N, classes, 1, 1, 1) (the JAX hook's
    are channels-last, (N, 1, 1, 1, classes)).

    The clip takes the JAX hook's transform on ``device`` (``num_frames``
    frames evenly spaced, /255, normalized, short side scaled to
    ``side_size``; :func:`transform_on`); the boxes, in the frame's pixels,
    are scaled to the scaled frame, and both are centre cropped to
    ``crop_size`` with the boxes clipped to the crop (the JAX hook's
    arithmetic, on the host). The
    weights are ``state_dict`` (the JAX hook's ``variables``), else the
    builder's random init; the model runs eagerly under
    ``torch.inference_mode()`` (the box count changes from frame to frame).
    The hook feeds one clip, so a pathway model (``slowfast_r50_detection``)
    raises ValueError here; the JAX hook fails the same way, at its
    ``init``."""

    def __init__(
        self,
        state_dict: Optional[dict] = None,
        model_name: str = "slow_r50_detection",
        num_frames: int = 4,
        side_size: int = 256,
        crop_size: int = 256,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
        device: Union[str, torch.device] = "cuda",
        **model_kwargs,
    ):
        super().__init__(inputs=["video", "bbox_coordinates"], outputs=["action_scores"],
                         fail_strategy=fail_strategy, priority=priority)
        self.device = torch.device(device)
        self.crop_size = crop_size
        self.transform = Compose([
            UniformTemporalSubsample(num_frames),
            Div255(),
            Normalize([0.45] * 3, [0.225] * 3),
            ShortSideScale(side_size),
        ])
        self.model = getattr(hub, model_name)(device=self.device, **model_kwargs).eval()
        if any(isinstance(m, MultiPathWayWithFuse) for m in self.model.modules()):
            raise ValueError(f"{model_name} takes a list of pathway clips; ActionDetectionHook "
                             "feeds one clip")
        if state_dict is not None:
            self.model.load_state_dict(state_dict)

    def _run(self, status: MutableMapping) -> dict:
        h, w = status["video"].shape[1:3]
        video = transform_on(self.transform, status["video"], self.device)
        sh, sw = video.shape[1], video.shape[2]
        boxes = np.asarray(torch.as_tensor(status["bbox_coordinates"]).cpu(), np.float32)
        boxes = boxes.reshape(-1, 4) * np.asarray([sw / w, sh / h, sw / w, sh / h], np.float32)
        y0 = max((sh - self.crop_size) // 2, 0)
        x0 = max((sw - self.crop_size) // 2, 0)
        video = video[:, y0:y0 + self.crop_size, x0:x0 + self.crop_size]
        boxes = np.clip(boxes - np.asarray([x0, y0, x0, y0], np.float32), 0, self.crop_size)
        rois = np.concatenate([np.zeros((len(boxes), 1), np.float32), boxes], axis=1)
        with torch.inference_mode():
            scores = self.model(thwc_to_cthw(video)[None], torch.from_numpy(rois).to(self.device))
        return {"action_scores": scores}

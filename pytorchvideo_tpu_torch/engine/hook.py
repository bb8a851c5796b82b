"""Inference hooks: units with named inputs and outputs and a failure
strategy (counterpart of pytorchvideo_tpu/engine/hook.py; upstream
pytorchvideo/neural_engine/hook.py: FAIL_STRATEGY :17, HookBase :97-144,
DecodeHook :155, X3DClsHook :184).

Values in the status dict are tensors: a decoded video is the port's (T, H,
W, C) uint8 clip, where the JAX hooks hand numpy float32 arrays on.
"""

from __future__ import annotations

import logging
from typing import Callable, List, MutableMapping, Optional, Union

import torch

from pytorchvideo_tpu_torch.accelerate.deploy import CompiledForward
from pytorchvideo_tpu_torch.models import hub
from pytorchvideo_tpu_torch.transforms import (
    CenterCropVideo,
    Compose,
    Div255,
    Normalize,
    ShortSideScale,
    UniformTemporalSubsample,
)
from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

logger = logging.getLogger(__name__)

FAIL_STRATEGY = ("RANDOM_FILL", "ZERO_FILL", "RETURN_NONE", "RAISE_ERROR")
HOOK_STATUS = ("PENDING", "SCHEDULED", "EXECUTING", "EXECUTED", "FAILED", "EARLY_EXIT")


class HookBase:
    """A pipeline unit: ``executor(status)`` (or a subclass's ``_run``)
    returns a dict of its ``outputs``. When it raises, ``fail_strategy``
    decides: re-raise ("RAISE_ERROR"), or give every output None
    ("RETURN_NONE"), a (1,) zero tensor ("ZERO_FILL") or a (1,) uniform draw
    from ``generator`` ("RANDOM_FILL"; torch's default generator when None)."""

    def __init__(
        self,
        executor: Optional[Callable] = None,
        inputs: Optional[List[str]] = None,
        outputs: Optional[List[str]] = None,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        if fail_strategy not in FAIL_STRATEGY:
            raise ValueError(f"fail_strategy must be one of {FAIL_STRATEGY}, got "
                             f"{fail_strategy!r}")
        self.executor = executor
        self.inputs = inputs or []
        self.outputs = outputs or []
        self.fail_strategy = fail_strategy
        self.priority = priority
        self.generator = generator
        self.status = "PENDING"

    def run(self, status: MutableMapping) -> dict:
        self.status = "EXECUTING"
        try:
            out = self._run(status)
            self.status = "EXECUTED"
            return out or {}
        except Exception as e:
            self.status = "FAILED"
            if self.fail_strategy == "RAISE_ERROR":
                raise
            logger.warning("hook %s failed (%s): %s", type(self).__name__, self.fail_strategy, e)
            if self.fail_strategy == "RETURN_NONE":
                return {k: None for k in self.outputs}
            if self.fail_strategy == "RANDOM_FILL":
                return {k: torch.rand(1, generator=self.generator) for k in self.outputs}
            return {k: torch.zeros(1) for k in self.outputs}

    def _run(self, status: MutableMapping) -> dict:
        if self.executor is None:
            return {}
        return self.executor(status)

    def get_inputs(self):
        return self.inputs

    def get_outputs(self):
        return self.outputs


def full_decode(status: MutableMapping, **args) -> dict:
    """The whole video at ``status["path"]`` (upstream hook.py:146-152):
    ``{"video": (T, H, W, C) uint8 tensor, "audio": None}``."""
    from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo

    video = EncodedVideo.from_path(status["path"], decode_audio=args.get("decode_audio", False),
                                   decoder=args.get("decoder", "opencv"))
    try:
        return video.get_clip(0, video.duration)
    finally:
        video.close()


class DecodeHook(HookBase):
    """path -> video (and audio) (upstream hook.py:155-181). The default
    executor decodes with OpenCV, which the card's machine lacks: there a
    pipeline starts from a decoded ``"video"``."""

    def __init__(
        self,
        executor: Callable = full_decode,
        decode_audio: bool = False,
        decoder: str = "opencv",
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
    ):
        super().__init__(executor=executor, inputs=["path"],
                         outputs=["video", "audio"] if decode_audio else ["video"],
                         fail_strategy=fail_strategy, priority=priority)
        self.decode_audio = decode_audio
        self.decoder = decoder

    def _run(self, status: MutableMapping) -> dict:
        clip = self.executor(status, decode_audio=self.decode_audio, decoder=self.decoder)
        out = {"video": clip["video"]}
        if self.decode_audio:
            out["audio"] = clip.get("audio")
        return out


def transform_on(transform: Compose, video, device: Union[str, torch.device]) -> torch.Tensor:
    """``transform`` of a status ``"video"`` (a (T, H, W, C) tensor or numpy
    array, uint8 or float in [0, 255]) on ``device``. Its first step, the
    temporal subsample, picks the frames where the video lies, so only
    those are copied to ``device`` (an index pick: the result is the whole
    chain's on ``device``)."""
    first, *rest = transform.transforms
    x = first(torch.as_tensor(video)).to(device)
    for t in rest:
        x = t(x)
    return x


class X3DClsHook(HookBase):
    """video -> action_class: (1, 400) logits of an X3D-S classifier
    (upstream hook.py:184-232), in eval mode and float32 on ``device``.

    The clip goes through the JAX hook's transform (``num_frames`` frames
    evenly spaced, /255, normalized, short side scaled to ``side_size``,
    centre crop of ``crop_size``) on ``device`` (:func:`transform_on`). The
    weights are ``state_dict`` (the JAX hook's ``variables``), else the
    builder's random init. On the card the forward is a :class:`CompiledForward` captured at
    the hook's one clip shape, as the JAX hook jits it; on the CPU it runs
    eagerly. A hook built for "cuda" without a card raises."""

    def __init__(
        self,
        state_dict: Optional[dict] = None,
        fail_strategy: str = "RAISE_ERROR",
        priority: int = 1,
        num_frames: int = 13,
        side_size: int = 182,
        crop_size: int = 160,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(inputs=["video"], outputs=["action_class"],
                         fail_strategy=fail_strategy, priority=priority)
        self.device = torch.device(device)
        self.transform = Compose([
            UniformTemporalSubsample(num_frames),
            Div255(),
            Normalize([0.45] * 3, [0.225] * 3),
            ShortSideScale(side_size),
            CenterCropVideo(crop_size),
        ])
        self.model = hub.x3d_s(model_num_class=400, device=self.device).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        if self.device.type == "cuda":
            example = torch.zeros(1, 3, num_frames, crop_size, crop_size, device=self.device)
            self._forward = CompiledForward(self.model, example)
        else:
            self._forward = self.model

    def _run(self, status: MutableMapping) -> dict:
        video = transform_on(self.transform, status["video"], self.device)
        with torch.inference_mode():
            return {"action_class": self._forward(thwc_to_cthw(video)[None])}

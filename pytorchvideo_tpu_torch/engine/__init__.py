"""The inference engine of the port (counterpart of pytorchvideo_tpu/engine):
a NeuralEngine of hooks (decode, X3D classification, person boxes, action
detection) over one status dict."""

from pytorchvideo_tpu_torch.engine.detection_hook import (  # noqa: F401
    ActionDetectionHook,
    Detectron2PeopleDetectionHook,
    ImageLoadHook,
    PeopleDetectionHook,
    PeopleKeypointDetectionHook,
    full_frame_person_boxes,
    generate_predictor,
    image_load_executor,
    people_detection_executor,
    people_keypoints_executor,
)
from pytorchvideo_tpu_torch.engine.engine import NeuralEngine  # noqa: F401
from pytorchvideo_tpu_torch.engine.hook import (  # noqa: F401
    FAIL_STRATEGY,
    HOOK_STATUS,
    DecodeHook,
    HookBase,
    X3DClsHook,
    full_decode,
)

"""The data feed of the port (counterpart of pytorchvideo_tpu/data): clip
samplers, video samplers, the labeled video dataset over OpenCV or native
decoding and frame directories, the dataset families (Kinetics, UCF101,
HMDB51, Charades, SSv2, the JSON datasets, AVA, EPIC-Kitchens, DoMSEV,
Ego4d with its audio front end), the packed ClipStore, and the batch loader
with its prefetch to the card. As in the JAX package, the native decoder
(``encoded_video_native``, ``native_pipeline``) is imported from its
modules, not exported here."""

from pytorchvideo_tpu_torch.data.ava import (  # noqa: F401
    Ava,
    AvaLabeledVideoFramePaths,
    TimeStampClipSampler,
)
from pytorchvideo_tpu_torch.data.clip_sampling import (  # noqa: F401
    ClipInfo,
    ClipInfoList,
    ClipSampler,
    ConstantClipsPerVideoSampler,
    RandomClipSampler,
    RandomMultiClipSampler,
    UniformClipSampler,
    UniformClipSamplerTruncateFromStart,
    make_clip_sampler,
)
from pytorchvideo_tpu_torch.data.charades import Charades  # noqa: F401
from pytorchvideo_tpu_torch.data.clip_store import ClipStore, prepare_clip_store  # noqa: F401
from pytorchvideo_tpu_torch.data.domsev import (  # noqa: F401
    DomsevFrameDataset,
    DomsevVideoDataset,
    LabelData,
)
from pytorchvideo_tpu_torch.data.ego4d import Ego4dImuData, Ego4dMomentsDataset  # noqa: F401
from pytorchvideo_tpu_torch.data.encoded_video import (  # noqa: F401
    EncodedVideo,
    EncodedVideoOpenCV,
)
from pytorchvideo_tpu_torch.data.epic_kitchen import ActionData, EpicKitchenDataset  # noqa: F401
from pytorchvideo_tpu_torch.data.epic_kitchen_forecasting import (  # noqa: F401
    EpicKitchenForecasting,
)
from pytorchvideo_tpu_torch.data.epic_kitchen_recognition import (  # noqa: F401
    EpicKitchenRecognition,
)
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo  # noqa: F401
from pytorchvideo_tpu_torch.data.hmdb51 import Hmdb51, Hmdb51LabeledVideoPaths  # noqa: F401
from pytorchvideo_tpu_torch.data.json_dataset import (  # noqa: F401
    UntrimmedClipSampler,
    clip_recognition_dataset,
    video_only_dataset,
)
from pytorchvideo_tpu_torch.data.kinetics import Kinetics  # noqa: F401
from pytorchvideo_tpu_torch.data.labeled_video_dataset import (  # noqa: F401
    LabeledVideoDataset,
    labeled_video_dataset,
)
from pytorchvideo_tpu_torch.data.labeled_video_paths import LabeledVideoPaths  # noqa: F401
from pytorchvideo_tpu_torch.data.loader import (  # noqa: F401
    BatchLoader,
    DevicePrefetch,
    device_prefetch,
)
from pytorchvideo_tpu_torch.data.samplers import (  # noqa: F401
    DistributedSampler,
    RandomSampler,
    SequentialSampler,
)
from pytorchvideo_tpu_torch.data.ssv2 import SSv2  # noqa: F401
from pytorchvideo_tpu_torch.data.ucf101 import Ucf101  # noqa: F401
from pytorchvideo_tpu_torch.data.video import Video, VideoPathHandler  # noqa: F401

"""The data feed of the port (counterpart of pytorchvideo_tpu/data): clip
samplers, video samplers, the labeled video dataset over OpenCV decoding
and frame directories, the AVA dataset, the packed ClipStore, and the batch
loader with its prefetch to the card. The native decoder's binding and the
other dataset families (Kinetics, UCF101, Charades, ...) wait (ROADMAP
queue 1, item 5)."""

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
from pytorchvideo_tpu_torch.data.clip_store import ClipStore, prepare_clip_store  # noqa: F401
from pytorchvideo_tpu_torch.data.encoded_video import (  # noqa: F401
    EncodedVideo,
    EncodedVideoOpenCV,
)
from pytorchvideo_tpu_torch.data.frame_video import FrameVideo  # noqa: F401
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
from pytorchvideo_tpu_torch.data.video import Video, VideoPathHandler  # noqa: F401

"""Training of the port (counterpart of pytorchvideo_tpu/train): the train
step with its mixed-precision policy, optimizer groups, LR schedules,
configs and presets, and the classification train app. So far it trains
MViT; see train/app.py for what waits."""

from pytorchvideo_tpu_torch.train.app import VideoClassificationTrainApp  # noqa: F401
from pytorchvideo_tpu_torch.train.config import (  # noqa: F401
    DataConfig,
    MixConfig,
    ModelConfig,
    TrainerConfig,
    VideoClassificationTrainConfig,
    save_config,
)
from pytorchvideo_tpu_torch.train.logger import MetricsLogger  # noqa: F401
from pytorchvideo_tpu_torch.train.lr_policy import (  # noqa: F401
    LRSchedulerConfig,
    get_lr_at_epoch,
)
from pytorchvideo_tpu_torch.train.optimizer import (  # noqa: F401
    OptimizerConfig,
    construct_optimizer,
    lr_schedule_from_config,
    param_labels,
)
from pytorchvideo_tpu_torch.train.presets import PRESETS, get_preset  # noqa: F401
from pytorchvideo_tpu_torch.train.train_loop import (  # noqa: F401
    TrainState,
    forward_backward,
    make_eval_step,
    make_train_step,
)
from pytorchvideo_tpu_torch.train.transforms import MixVideoBatchWrapper  # noqa: F401

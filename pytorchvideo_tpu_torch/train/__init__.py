"""Training of the port (counterpart of pytorchvideo_tpu/train): the train
and eval steps with their mixed-precision policy and activation
rematerialisation, the step captured in a CUDA graph, optimizer groups
with the LR on the device, LR schedules, precise BN, metrics, the trainer
losses, configs and presets, and the classification train app with its
test and predict passes and the SSL backbone graft, and the datamodule
that feeds it from videos; self-supervised pretraining (BYOL, SimCLR,
MoCo v2) with LARS, the SSL transforms and ``SSLTrainApp``; the sharded
step of tensor parallelism and FSDP (``run_sharded_step``). It trains the
BatchNorm models (X3D, Slow, SlowFast and the other ResNet builders; the
recipes ``classification_x3d_xs``, ``classification_slow_8x8_r50`` and
``classification_slowfast_8x8_r50``) and MViT (``classification_mvit_16x4``);
see train/app.py for what waits."""

from pytorchvideo_tpu_torch.train.app import VideoClassificationTrainApp  # noqa: F401
from pytorchvideo_tpu_torch.train.compiled_step import CompiledTrainStep  # noqa: F401
from pytorchvideo_tpu_torch.train.datamodule import VideoClassificationDataModule  # noqa: F401
from pytorchvideo_tpu_torch.train.config import (  # noqa: F401
    DataConfig,
    MixConfig,
    ModelConfig,
    TrainerConfig,
    VideoClassificationTrainConfig,
    config_from_dict,
    config_to_dict,
    save_config,
)
from pytorchvideo_tpu_torch.train.logger import MetricsLogger  # noqa: F401
from pytorchvideo_tpu_torch.train.losses import (  # noqa: F401
    contrastive_loss,
    ntxent_loss,
    similarity_loss,
)
from pytorchvideo_tpu_torch.train.metrics import (  # noqa: F401
    average_precision,
    mean_average_precision,
    top1_top5,
    topk_accuracy,
)
from pytorchvideo_tpu_torch.train.lr_policy import (  # noqa: F401
    LRSchedulerConfig,
    get_epoch_lr,
    get_lr_at_epoch,
)
from pytorchvideo_tpu_torch.train.optimizer import (  # noqa: F401
    LARS,
    OptimizerConfig,
    construct_optimizer,
    load_optimizer_state,
    lr_schedule_from_config,
    param_labels,
    set_lr,
)
from pytorchvideo_tpu_torch.train.precise_batchnorm import PreciseBn, update_bn_stats  # noqa: F401
from pytorchvideo_tpu_torch.train.presets import PRESETS, get_preset  # noqa: F401
from pytorchvideo_tpu_torch.train.sharded import ShardedStep, run_sharded_step  # noqa: F401
from pytorchvideo_tpu_torch.train.ssl import (  # noqa: F401
    KnnMemory,
    MoCoV2,
    batch_shuffle,
    batch_unshuffle,
    momentum_anneal_cosine,
)
from pytorchvideo_tpu_torch.train.ssl_app import (  # noqa: F401
    SSLConfig,
    SSLTrainApp,
    SSLTrainState,
    SSLTrainStep,
    TwoViewTransform,
    make_byol_train_step,
    make_moco_train_step,
    make_simclr_train_step,
    ssl_train_state,
)
from pytorchvideo_tpu_torch.train.train_loop import (  # noqa: F401
    REMAT_POLICIES,
    TRAIN_MARKS,
    TrainState,
    TrainStep,
    create_train_state,
    ensemble_video_level,
    forward_backward,
    make_eval_step,
    make_train_step,
)
from pytorchvideo_tpu_torch.train.transforms import (  # noqa: F401
    ColorJitterVideoSSl,
    GaussianBlur,
    MixVideoBatchWrapper,
    RandomErasing,
    RepeatandConverttoList,
    SlowFastPackPathway,
    build_collator_from_name,
    default_collate,
    multiple_samples_collate,
)

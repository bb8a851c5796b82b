"""Every module of the port, and chip_smoke.py, imports on a machine like
the card's: without jax, the JAX package, any video decoder or image
library (OpenCV, PyAV, decord, PIL), torchvision or networkx. The data
feed, the transforms, detection, the engine, self-supervised pretraining,
the efficient blocks, the transmuter, int8 serving, the utils, audio-visual
SlowFast, the masked multistream and the dataset families are among the
modules imported."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("jax", "pytorchvideo_tpu", "cv2", "av", "decord", "PIL", "torchvision", "networkx")
NEW_MODULES = ("data.clip_sampling", "data.clip_store", "data.encoded_video",
               "data.labeled_video_dataset", "data.labeled_video_paths", "data.loader",
               "data.samplers", "data.utils", "data.io", "data.video",
               "transforms.functional", "transforms.transforms", "transforms.augmentations",
               "transforms.rand_augment", "transforms.augmix", "transforms.transforms_factory",
               "train.datamodule", "ops.roi_align", "models.detection", "models.net",
               "models.hub.utils", "models.hub.resnet", "models.hub.slowfast", "engine",
               "engine.engine", "engine.hook", "engine.detection_hook", "data.frame_video",
               "data.ava", "layers.mlp", "models.byol", "models.simclr", "models.memory_bank",
               "train.ssl", "train.ssl_app", "accelerate.efficient_blocks",
               "accelerate.conv_blocks", "accelerate.transmuter", "accelerate.quantize",
               "accelerate.int8", "models.hub.efficient_x3d", "utils", "utils.flops",
               "utils.profiling", "models.audio_visual_slowfast", "models.masked_multistream",
               "parallel", "parallel.distributed", "parallel.collectives", "parallel.mesh",
               "parallel.sequence", "layers.batch_norm", "parallel.sharding", "parallel.tensor",
               "train.sharded", "data.dataset_manifest_utils", "data.kinetics", "data.ucf101",
               "data.hmdb51", "data.charades", "data.ssv2", "data.json_dataset",
               "data.epic_kitchen", "data.epic_kitchen.utils",
               "data.epic_kitchen.epic_kitchen_dataset", "data.epic_kitchen_recognition",
               "data.epic_kitchen_forecasting", "data.domsev", "data.ego4d", "data.ego4d.utils",
               "data.ego4d.ego4d_dataset", "data.encoded_video_native", "data.native_pipeline",
               "data.native_build")
# Names the JAX package's packages export, which the port's export under the
# same names.
JAX_EXPORTS = {
    "layers": ("NaiveSyncBatchNorm1d", "NaiveSyncBatchNorm2d", "NaiveSyncBatchNorm3d",
               "BatchNorm3d", "Identity", "scaled_dot_product_attention"),
    "ops": ("pooled_attention", "pooled_attention_packed", "depthwise_token_pool",
            "max_token_pool", "avg_token_pool"),
    "train": ("create_train_state", "get_epoch_lr"),
    "parallel": ("make_mesh", "batch_sharding", "replicated", "shard_batch",
                 "all_gather_with_grad", "cat_all_gather", "sequence_parallel_attention",
                 "infer_param_shardings", "optimizer_state_shardings"),
    "data": ("Kinetics", "Ucf101", "Hmdb51", "Hmdb51LabeledVideoPaths", "Charades", "SSv2",
             "UntrimmedClipSampler", "clip_recognition_dataset", "video_only_dataset",
             "ActionData", "EpicKitchenDataset", "EpicKitchenRecognition",
             "EpicKitchenForecasting", "DomsevFrameDataset", "DomsevVideoDataset", "LabelData",
             "Ego4dImuData", "Ego4dMomentsDataset"),
    "data.ego4d": ("signal_transform", "MomentsClipSampler", "check_window_len",
                   "get_label_id_map", "Ego4dImuDataBase"),
    "parallel.distributed": ("get_world_size", "get_local_size", "get_rank",
                             "init_distributed_training", "local_sync_groups"),
}
# Rule tables both export: one rule of the port's for each of the JAX package's.
JAX_TABLES = {"parallel": ("MEGATRON_ATTENTION_RULES",)}


def test_every_port_module_imports_without_jax_or_a_decoder():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import pytorchvideo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"missing = [n for n in {NEW_MODULES!r} if 'pytorchvideo_tpu_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        f"assert not [n for n in {BLOCKED!r} if sys.modules.get(n) is not None]\n"
        "# Importing the native decoder builds and loads nothing.\n"
        "assert sys.modules['pytorchvideo_tpu_torch.data.encoded_video_native']._LIB is None\n"
        "print('ok', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_jax_package_exports_are_the_port_s_too():
    import importlib

    for module, names in JAX_EXPORTS.items():
        jax_module = importlib.import_module(f"pytorchvideo_tpu.{module}")
        port = importlib.import_module(f"pytorchvideo_tpu_torch.{module}")
        for name in names:
            assert hasattr(jax_module, name), f"pytorchvideo_tpu.{module}.{name}"
            assert callable(getattr(port, name, None)), f"pytorchvideo_tpu_torch.{module}.{name}"
    for module, names in JAX_TABLES.items():
        jax_module = importlib.import_module(f"pytorchvideo_tpu.{module}")
        port = importlib.import_module(f"pytorchvideo_tpu_torch.{module}")
        for name in names:
            assert len(getattr(port, name)) == len(getattr(jax_module, name)), name


HUB_MODULES = ("x3d", "csn", "r2plus1d", "resnet", "slowfast", "vision_transformers")


@pytest.mark.parametrize("module", HUB_MODULES)
def test_hub_checkpoint_names_are_jax_s(module):
    import importlib

    ours = importlib.import_module(f"pytorchvideo_tpu_torch.models.hub.{module}")
    theirs = importlib.import_module(f"pytorchvideo_tpu.models.hub.{module}")
    assert ours.checkpoint_names == theirs.checkpoint_names
    # Each name is a factory of the module.
    assert all(callable(getattr(ours, name)) for name in ours.checkpoint_names)


def test_set_attributes_as_jax_s():
    from pytorchvideo_tpu.layers.utils import set_attributes as jax_set_attributes
    from pytorchvideo_tpu_torch.layers.utils import set_attributes

    class Holder:
        pass

    def params(self, a, b=2, *, c=None):
        return dict(locals())

    ours, theirs = Holder(), Holder()
    set_attributes(ours, params(ours, 1, c="x"))
    jax_set_attributes(theirs, params(theirs, 1, c="x"))
    assert vars(ours) == vars(theirs) == {"a": 1, "b": 2, "c": "x"}
    set_attributes(ours, None)
    set_attributes(ours, {})
    assert vars(ours) == {"a": 1, "b": 2, "c": "x"}


EXAMPLES = ("eval_kinetics", "hub_inference", "visualization", "video_detection",
            "video_classification", "ssl_pretraining", "accelerator_deployment")


def test_examples_import_neither_jax_nor_the_jax_package():
    """Every script of examples_torch/ imports on a machine like the card's,
    and no import statement in it, at top level or inside a function, names
    jax, the JAX package or the JAX scripts' examples/."""
    import ast

    assert sorted(p.stem for p in (REPO / "examples_torch").glob("*.py")) == sorted(EXAMPLES)
    for name in EXAMPLES:
        tree = ast.parse((REPO / "examples_torch" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "pytorchvideo_tpu", "examples", "flax"} & set(roots), (name, roots)
    code = (
        "import importlib, sys\n"
        f"for name in {BLOCKED + ('examples', 'flax')!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {EXAMPLES!r}:\n"
        "    importlib.import_module('examples_torch.' + name)\n"
        f"assert not [n for n in {BLOCKED!r} if sys.modules.get(n) is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")

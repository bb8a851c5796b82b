"""Kinetics-style model-zoo evaluation harness on the PyTorch/CUDA port.

Given a reference ``.pyth`` checkpoint and a val csv ("<path> <label>" per
line), runs the model-zoo test protocol: N uniform temporal clips x M
spatial crops per video, the logits ensembled per video by sum (upstream
module/video_classification.py:275-311; views per model in upstream
docs/source/model_zoo.md:63), and reports top-1 and top-5.

The port keeps upstream's ``state_dict`` keys, so a ``.pyth`` loads with no
rename rules. The model runs in float32 on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``).

Usage:
    python examples_torch/eval_kinetics.py --model slow_r50 \
        --checkpoint SLOW_8x8_R50.pyth --data val.csv
    python examples_torch/eval_kinetics.py --model x3d_s --checkpoint X3D_S.pyth \
        --data val.csv
    # smoke-run on synthetic videos (written with OpenCV) and random weights:
    python examples_torch/eval_kinetics.py --model x3d_s --synthetic

Per-model eval settings (frames, sampling rate, side/crop size, views)
default to upstream's published protocol and can be overridden by flags.
Videos are decoded by the native decoder (FFmpeg, built at first use);
``evaluate(video_path_handler=...)`` takes videos from elsewhere, such as
frames already in memory (:class:`ArrayVideoPathHandler`).
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# (num_frames, sampling_rate, side_size, crop_size, clips, spatial_crops,
#  slowfast_alpha) per model. Provenance, cross-checked against upstream
# (frame length x sample rate and the "views" column are the Kinetics-400
# table in upstream docs/source/model_zoo.md:8-27; views are spatial_crops x
# clips, e.g. "3 x 10"):
#   - resnet-family side/crop 256: upstream
#     website/docs/tutorial_torchhub_inference.md:84-91 (slowfast: also
#     num_frames=32, sampling_rate=2, alpha=4; the slow pathway's
#     UniformTemporalSubsample(num_frames//alpha) is the published 8x8
#     protocol) and pytorchvideo_trainer conf
#     datamodule/transforms/kinetics_classification_{slow,slowfast}.yaml
#     test sections (ShortSideScale 256 + UniformCropVideo 256).
#   - slowfast_16x8_r101_50_50: zoo row "16x8" is the slow pathway; the
#     fast pathway decodes 64 frames at rate 2 with alpha=4 (upstream
#     hub/slowfast.py checkpoint naming + model_zoo.md:16).
#   - csn_r101 (32x2) / r2plus1d_r50 (16x4): zoo rows model_zoo.md:17-18;
#     256 side/crop is the family test protocol above (upstream publishes
#     no per-model transform override for them).
#   - x3d_xs: trainer conf kinetics_classification_x3d_xs.yaml test
#     section (ShortSideScale 182 + crop 182); frames/rate model_zoo.md:19.
#   - x3d_s/m: torchhub tutorial transform_params (182/182 @ 13x6,
#     256/256 @ 16x5); x3d_l: 356 short side at 16x5 per the X3D test
#     protocol the zoo row's FLOPs imply (no published yaml; flagged).
#   - mvit: hub/vision_transformers.py:22 spatial_size 224 and trainer
#     conf kinetics_classification_mvit_16x4.yaml test section
#     (ShortSideScale 224 + UniformCropVideo 224, not 256); views 1x5
#     (model_zoo.md:22-23).
EVAL_CONFIGS = {
    "c2d_r50": (8, 8, 256, 256, 10, 3, None),
    "i3d_r50": (8, 8, 256, 256, 10, 3, None),
    "slow_r50": (8, 8, 256, 256, 10, 3, None),
    "slowfast_r50": (32, 2, 256, 256, 10, 3, 4),
    "slowfast_r101": (32, 2, 256, 256, 10, 3, 4),
    "slowfast_16x8_r101_50_50": (64, 2, 256, 256, 10, 3, 4),
    "csn_r101": (32, 2, 256, 256, 10, 3, None),
    "r2plus1d_r50": (16, 4, 256, 256, 10, 3, None),
    "x3d_xs": (4, 12, 182, 182, 10, 3, None),
    "x3d_s": (13, 6, 182, 182, 10, 3, None),
    "x3d_m": (16, 5, 256, 256, 10, 3, None),
    "x3d_l": (16, 5, 356, 356, 10, 3, None),
    "mvit_base_16x4": (16, 4, 224, 224, 5, 1, None),
    "mvit_base_32x3": (32, 3, 224, 224, 5, 1, None),
}

KINETICS_MEAN = [0.45, 0.45, 0.45]
KINETICS_STD = [0.225, 0.225, 0.225]


def resolve_device(name):
    """``name`` as a torch.device; "cuda" on a host without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")
    return device


def build_model(name, num_classes, device, **kwargs):
    """The hub model ``name`` with ``num_classes`` outputs on ``device``
    (MViT's factory names the count ``head_num_classes``), in eval mode."""
    from pytorchvideo_tpu_torch.models import hub

    key = "head_num_classes" if name.startswith("mvit_") else "model_num_class"
    return getattr(hub, name)(**{key: num_classes}, device=device, **kwargs).eval()


class ArrayVideo:
    """A video held as (T, H, W, C) uint8 frames at ``fps``, with the
    decoders' clip arithmetic (data/encoded_video.py): ``get_clip(start,
    end)`` returns the frames whose times ``i / fps`` lie in [start, end)."""

    def __init__(self, frames, fps, name):
        self._frames = frames
        self._fps = float(fps)
        self._video_name = name

    @property
    def name(self):
        return self._video_name

    @property
    def duration(self):
        return len(self._frames) / self._fps

    def get_clip(self, start_sec, end_sec):
        n = len(self._frames)
        if start_sec > end_sec or start_sec > self.duration:
            return {"video": None, "audio": None}
        start = max(int(math.ceil(self._fps * start_sec - 1e-9)), 0)
        end = n if end_sec == math.inf else min(int(math.ceil(self._fps * end_sec - 1e-9)), n)
        if end <= start:
            end = min(start + 1, n)
        if end <= start:
            return {"video": None, "audio": None}
        return {"video": self._frames[start:end], "audio": None}

    def close(self):
        pass


class ArrayVideoPathHandler:
    """Stands in for ``LabeledVideoDataset.video_path_handler``: each path
    of the csv names one entry of ``videos`` ({name: (T, H, W, C) uint8
    frames}), played at ``fps``; nothing is decoded."""

    def __init__(self, videos, fps):
        self.videos = videos
        self.fps = fps

    def video_from_path(self, filepath, decode_video=True, decode_audio=False, decoder=None,
                        fps=None):
        return ArrayVideo(self.videos[filepath], self.fps, filepath)


def write_csv(path, labeled_names):
    """A val csv of ``(name, label)`` pairs, one ``<name> <label>`` line each."""
    with open(path, "w") as f:
        for name, label in labeled_names:
            f.write(f"{name} {label}\n")
    return path


def build_transform(num_frames, side_size, crop_size, alpha):
    """The test chain on a sample's (T, H, W, C) uint8 clip: frames evenly
    subsampled, /255, normalized, short side scaled, the crop of the
    sample's ``aug_index``; then CTHW (a view, so batches collate
    ``channels_last_3d``), as SlowFast's ``[slow, fast]`` where ``alpha``."""
    from pytorchvideo_tpu_torch.train.transforms import SlowFastPackPathway
    from pytorchvideo_tpu_torch.transforms import (
        ApplyTransformToKey,
        Compose,
        Div255,
        Normalize,
        ShortSideScale,
        UniformCropVideo,
        UniformTemporalSubsample,
    )
    from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

    video_chain = ApplyTransformToKey("video", Compose([
        UniformTemporalSubsample(num_frames),
        Div255(),
        Normalize(KINETICS_MEAN, KINETICS_STD),
        ShortSideScale(side_size),
    ]))
    crop = UniformCropVideo(crop_size)
    pack = SlowFastPackPathway(alpha) if alpha is not None else None

    def transform(sample):
        sample = crop(video_chain(sample))
        video = thwc_to_cthw(sample["video"])
        sample["video"] = pack(video) if pack is not None else video
        return sample

    return transform


def evaluate(
    model,
    data_csv,
    *,
    num_frames,
    sampling_rate,
    side_size,
    crop_size,
    clips_per_video,
    spatial_crops,
    alpha,
    batch_size,
    fps=30.0,
    ensemble_method="sum",
    prefetch=False,
    video_path_handler=None,
    record=None,
):
    """Runs the protocol over ``data_csv`` with ``model`` (an eval-mode
    module; the batches go to its parameters' device) and returns the
    metrics dict of the JAX package's harness.

    ``video_path_handler`` replaces the dataset's decoder (an object with
    ``video_from_path(path, ...)`` returning a Video). ``record``, a dict,
    receives ``ensembled`` (the (videos, classes) ensembled logits on the
    model's device), ``video_index`` (each view's video index in the order
    run), ``batches``, and per batch ``wait_ms`` (the host waiting for the
    loader) and ``call_ms`` (the host in the forward call)."""
    from pytorchvideo_tpu_torch.data import (
        BatchLoader,
        SequentialSampler,
        device_prefetch,
        labeled_video_dataset,
        make_clip_sampler,
    )
    from pytorchvideo_tpu_torch.train.train_loop import ensemble_video_level

    device = next(model.parameters()).device
    clip_duration = num_frames * sampling_rate / fps
    ds = labeled_video_dataset(
        data_csv,
        make_clip_sampler("constant_clips_per_video", clip_duration, clips_per_video,
                          spatial_crops),
        video_sampler=SequentialSampler,
        transform=build_transform(num_frames, side_size, crop_size, alpha),
        decoder="native",
    )
    if video_path_handler is not None:
        ds.video_path_handler = video_path_handler
    num_videos = ds.num_videos
    loader = BatchLoader(ds, batch_size=batch_size, num_workers=4, drop_last=False)
    batches = device_prefetch(loader, device) if prefetch else loader

    def to_device(video):
        if isinstance(video, (list, tuple)):
            return [v.to(device) for v in video]
        return video.to(device)

    logits_list, vidx_list, wait_ms, call_ms = [], [], [], []
    labels = np.full(num_videos, -1, np.int64)
    n_views = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        it = iter(batches)
        while True:
            t_wait = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            t_call = time.perf_counter()
            logits_list.append(model(to_device(batch["video"])).float())
            t_done = time.perf_counter()
            wait_ms.append((t_call - t_wait) * 1e3)
            call_ms.append((t_done - t_call) * 1e3)
            vidx = np.asarray(torch.as_tensor(batch["video_index"]).cpu())
            vidx_list.append(vidx)
            labels[vidx] = np.asarray(torch.as_tensor(batch["label"]).cpu())
            n_views += len(vidx)
        ensembled = ensemble_video_level(logits_list, vidx_list, num_videos,
                                         method=ensemble_method)
        host = ensembled.cpu().numpy()
    wall_s = time.perf_counter() - t0
    if record is not None:
        record.update(ensembled=ensembled, video_index=np.concatenate(vidx_list),
                      batches=len(logits_list), wait_ms=wait_ms, call_ms=call_ms)
    seen = labels >= 0
    order = np.argsort(-host[seen], axis=-1)
    gt = labels[seen][:, None]
    top1 = float((order[:, :1] == gt).any(-1).mean())
    top5 = float((order[:, :5] == gt).any(-1).mean())
    return {
        "num_videos": int(seen.sum()),
        "views": f"{clips_per_video}x{spatial_crops}",
        "top1": round(top1 * 100, 2),
        "top5": round(top5 * 100, 2),
        # the end-to-end rate of the decode -> transform -> load -> forward
        # loop, up to the ensembled logits on the host
        "wall_s": round(wall_s, 2),
        "views_per_s": round(n_views / wall_s, 2) if wall_s else None,
        # per-video argmax over the ensembled logits, ordered by video index
        "predictions": [int(p) for p in order[:, 0]],
    }


def make_synthetic_dataset(td, num_videos=4, num_classes=4, seconds=2.0, fps=10):
    """Seeded random 224x224 videos written losslessly (OpenCV, FFV1) into
    ``td``, and their val csv; returns the csv's path."""
    import cv2

    rng = np.random.default_rng(0)
    csv = os.path.join(td, "val.csv")
    with open(csv, "w") as f:
        for i in range(num_videos):
            p = os.path.join(td, f"v{i}.avi")
            wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"FFV1"), fps, (224, 224))
            for frame in rng.integers(0, 255, (int(seconds * fps), 224, 224, 3), np.uint8):
                wr.write(frame)
            wr.release()
            f.write(f"{p} {i % num_classes}\n")
    return csv


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="x3d_s", choices=sorted(EVAL_CONFIGS))
    parser.add_argument("--checkpoint", default=None, help=".pyth path")
    parser.add_argument("--data", default=None, help="val csv: '<path> <label>'")
    parser.add_argument("--num-classes", type=int, default=400)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--clips-per-video", type=int, default=None)
    parser.add_argument("--spatial-crops", type=int, default=None)
    parser.add_argument("--side-size", type=int, default=None)
    parser.add_argument("--crop-size", type=int, default=None)
    parser.add_argument("--ensemble", default="sum", choices=["sum", "max"])
    parser.add_argument("--synthetic", action="store_true",
                        help="smoke-run on generated videos with random-init weights")
    parser.add_argument("--synthetic-videos", type=int, default=4,
                        help="number of generated videos for --synthetic")
    parser.add_argument("--synthetic-seconds", type=float, default=2.0,
                        help="duration of each generated video for --synthetic")
    parser.add_argument("--prefetch", action="store_true",
                        help="copy each batch to the card ahead of the forward "
                             "(data.loader.device_prefetch)")
    parser.add_argument("--model-kwargs", default=None,
                        help="JSON dict of extra kwargs for the hub model builder "
                             "(e.g. tiny geometries in tests)")
    parser.add_argument("--deploy", action="store_true",
                        help="fold BN into the conv weights before eval "
                             "(accelerate/fuse.py fold_conv_bn); the metrics must equal the "
                             "unfolded run's")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from pytorchvideo_tpu_torch.models import hub

    num_frames, sampling_rate, side_size, crop_size, clips, crops, alpha = \
        EVAL_CONFIGS[args.model]
    clips = args.clips_per_video or clips
    crops = args.spatial_crops or crops
    side_size = args.side_size or side_size
    crop_size = args.crop_size or crop_size

    if not args.checkpoint and not args.synthetic:
        parser.error("--checkpoint required unless --synthetic")
    model_kwargs = json.loads(args.model_kwargs) if args.model_kwargs else {}
    torch.manual_seed(0)  # the random init of --synthetic
    model = build_model(args.model, args.num_classes, device, **model_kwargs)
    if args.checkpoint:
        hub.load_pretrained_variables(model, None, args.checkpoint)
    if args.deploy:
        from pytorchvideo_tpu_torch.accelerate.fuse import fold_conv_bn

        fold_conv_bn(model)

    def run(data_csv):
        return evaluate(
            model,
            data_csv,
            num_frames=num_frames,
            sampling_rate=sampling_rate,
            side_size=side_size,
            crop_size=crop_size,
            clips_per_video=clips,
            spatial_crops=crops,
            alpha=alpha,
            batch_size=args.batch_size,
            ensemble_method=args.ensemble,
            prefetch=args.prefetch,
        )

    if args.synthetic:
        with tempfile.TemporaryDirectory() as td:
            result = run(make_synthetic_dataset(td, num_videos=args.synthetic_videos,
                                                num_classes=args.num_classes,
                                                seconds=args.synthetic_seconds))
    else:
        if not args.data:
            parser.error("--data required unless --synthetic")
        result = run(args.data)

    result["model"] = args.model
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

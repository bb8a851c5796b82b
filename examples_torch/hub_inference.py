"""Hub inference walkthrough on the PyTorch/CUDA port: classify a video with
a model-zoo factory.

Parity: upstream tutorials/torchhub_inference_tutorial.ipynb (torch.hub.load
-> transform -> top-5 Kinetics classes). Here the same flow is: hub factory
-> (optional) upstream ``.pyth`` checkpoint, loaded with no rename rules ->
the first clip of the video -> val transform -> forward -> top-5. The video
is decoded with OpenCV on the host.

Usage:
  python examples_torch/hub_inference.py --video clip.mp4 \
      [--model x3d_s] [--checkpoint X3D_S.pyth] [--labels kinetics.json] \
      [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

# (num_frames, side, crop, frames_per_second sampling window)
MODEL_GEOM = {
    "x3d_xs": (4, 182, 160, 12),
    "x3d_s": (13, 182, 160, 6),
    "x3d_m": (16, 256, 224, 5),
    "slow_r50": (8, 256, 224, 8),
    "i3d_r50": (8, 256, 224, 8),
    "c2d_r50": (8, 256, 224, 8),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--model", default="x3d_s", choices=sorted(MODEL_GEOM))
    p.add_argument("--checkpoint", default="", help=".pyth upstream checkpoint")
    p.add_argument("--labels", default="", help="json list of class names")
    p.add_argument("--classes", type=int, default=400)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")

    from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo
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

    num_frames, side, crop, rate = MODEL_GEOM[args.model]
    torch.manual_seed(0)  # the random init without --checkpoint
    model = getattr(hub, args.model)(model_num_class=args.classes, device=device).eval()
    if args.checkpoint:
        hub.load_pretrained_variables(model, None, args.checkpoint)
    else:
        print("note: random weights (pass --checkpoint for real predictions)")

    transform = Compose(
        [
            UniformTemporalSubsample(num_frames),
            Div255(),
            Normalize([0.45] * 3, [0.225] * 3),
            ShortSideScale(side),
            CenterCropVideo(crop),
        ]
    )

    video = EncodedVideo.from_path(args.video, decode_audio=False)
    clip_dur = num_frames * rate / 30.0
    clip = video.get_clip(0, min(clip_dur, video.duration))["video"]
    video.close()
    x = thwc_to_cthw(transform(clip))[None].to(device)

    with torch.inference_mode():
        probs = torch.softmax(model(x)[0].float(), dim=-1).cpu()
    top5 = torch.argsort(probs, descending=True)[:5].tolist()

    names = None
    if args.labels:
        with open(args.labels) as f:
            names = json.load(f)
    result = []
    for rank, idx in enumerate(top5, 1):
        label = names[idx] if names else f"class_{idx}"
        print(f"{rank}. {label}  p={float(probs[idx]):.4f}")
        result.append((label, float(probs[idx])))
    return result


if __name__ == "__main__":
    main()

"""Video action-detection inference example on the PyTorch/CUDA port.

Parity: upstream tutorials/video_detection_inference_tutorial.ipynb +
tutorials/video_detection_example (detectron2 person boxes -> hub
slowfast_r50_detection -> VideoVisualizer). Here the NeuralEngine detection
pipeline runs: decode (OpenCV, on the host) -> person boxes (an injectable
predictor; a full-frame box when no detector is supplied) -> RoI-head
action model on ``--device`` -> annotated frames written as an .avi.

Usage:
  python examples_torch/video_detection.py --video clip.avi --out annotated.avi \
      [--boxes boxes.csv]    # optional: one `x0,y0,x1,y1` line per person
"""

import argparse
import os
import sys
from collections import OrderedDict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--out", default="annotated.avi")
    p.add_argument("--boxes", default="", help="csv of x0,y0,x1,y1 person boxes")
    p.add_argument("--model", default="slow_r50_detection")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--thres", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass --device cpu to run on the CPU")

    from examples_torch.visualization import VideoVisualizer
    from pytorchvideo_tpu_torch import engine
    from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo
    from pytorchvideo_tpu_torch.data.utils import export_video_array

    video = EncodedVideo.from_path(args.video)
    clip = video.get_clip(0, video.duration)["video"]
    video.close()

    predictor = None
    if args.boxes:
        fixed = np.loadtxt(args.boxes, delimiter=",").reshape(-1, 4)
        predictor = lambda img: fixed  # noqa: E731

    torch.manual_seed(0)  # the action model's random init
    pipeline = engine.NeuralEngine(
        [
            engine.PeopleDetectionHook(predictor=predictor),
            engine.ActionDetectionHook(model_name=args.model, num_frames=args.frames,
                                       device=device),
        ]
    )
    status = OrderedDict(loaded_image=clip[len(clip) // 2], video=clip)
    out = pipeline.run(status)
    boxes = out["bbox_coordinates"].cpu().numpy()
    scores = out["action_scores"].float().cpu().numpy().reshape(len(boxes), -1)
    print(f"{len(boxes)} boxes; top action score {scores.max():.3f}")

    vis = VideoVisualizer(num_classes=scores.shape[1], thres=args.thres)
    annotated = vis.draw_clip(clip.numpy(), boxes, scores)
    export_video_array(annotated, args.out, rate=8)
    print(f"wrote {args.out}")
    return {"boxes": boxes, "scores": scores, "annotated": annotated, "out": args.out}


if __name__ == "__main__":
    main()

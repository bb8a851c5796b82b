"""The native decoder's host figures: phase 28 (a)'s decode half without a
card.

    python3 benchmarks_torch/decode_host.py [--out decode_host.json]

Run from the root of a checkout on a machine with ``g++`` and FFmpeg's
development packages (``pkg-config`` libavformat, libavcodec, libavutil,
libswscale); it needs no card. It builds the decoder from ``native/``,
writes ``chip_smoke.av_file``'s seeded A/V file (300 frames of 240x320 at
30 fps, FFV1; 10 s of 48 kHz audio, pcm_s16le) under ``build/``, and runs
``chip_smoke.decode_checks`` on it: the whole file through ``from_path`` and
``from_bytes`` (frames bit for bit, audio within 2e-4), then eight 2 s clips
through one handle and through the 4-thread pipeline at the file's size and
rescaled to 182x242, on the host clock. Prints the figures as one JSON
object beside the host's CPU count and name, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from pytorchvideo_tpu_torch.data import native_build

    missing = native_build.missing_tools()
    if missing:
        sys.exit(f"decode_host: the native decoder cannot be built here: missing {missing}")
    t0 = time.perf_counter()
    native_build.build_library()
    build_s = time.perf_counter() - t0
    directory = os.path.join(REPO, "build", f"decode_host_{os.getpid()}")
    os.makedirs(directory)
    host = f"{os.cpu_count()} CPUs, {platform.processor() or platform.machine()}"
    try:
        path, frames, wave, write_s = cs.av_file(directory, torch.Generator().manual_seed(280))
        report = cs.decode_checks(path, frames, wave, host)[0]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    report.update(build_s=build_s, write_s=write_s, host=host,
                  torch_threads=torch.get_num_threads())
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()

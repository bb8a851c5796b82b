"""The packed clip store: decode once, then train or serve from fixed-shape
uint8 shards (counterpart of pytorchvideo_tpu/data/clip_store.py, whose
files it reads and writes bit for bit).

Layout of a store directory::

    index.json             # geometry, counts
    clips_00000.npy        # uint8 (n, T, H, W, 3), np.load(mmap_mode="r")
    labels_00000.npy       # int64 (n,)
    video_index_00000.npy  # int32 (n,)  (multi-clip eval ensembling keys)
    ...

Clips stay uint8 up to the card: a quarter of float32's bytes on disk, in
the page cache and over PCIe; ``/ 255`` and the normalization run on the
device (transforms/). A batch is a dict of CPU tensors; ``device_prefetch``
(data/loader.py) takes it to the card, and :meth:`ClipStore.prefetch`
gathers it straight into the prefetch's pinned buffers.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_INDEX = "index.json"


def prepare_clip_store(
    dataset,
    out_dir: str,
    clips_per_shard: int = 256,
    num_workers: int = 4,
    expected_shape: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, Any]:
    """Write ``dataset`` (any iterable of sample dicts whose "video" is a
    fixed-shape (T, H, W, 3) array or tensor: compose the sizing transform
    into the dataset) into uint8 shards under ``out_dir``.

    The dataset's own transform must make every clip the same shape
    (e.g. UniformTemporalSubsample -> ShortSideScale -> CenterCrop). Values
    may be float [0, 255] or uint8; both are stored as uint8.

    Returns the written index dict.
    """
    from pytorchvideo_tpu_torch.data.loader import BatchLoader

    os.makedirs(out_dir, exist_ok=True)
    shard, labels, vidx = [], [], []
    n_shards = 0
    total = 0
    t_h_w = expected_shape

    def flush():
        nonlocal n_shards, shard, labels, vidx
        if not shard:
            return
        np.save(
            os.path.join(out_dir, f"clips_{n_shards:05d}.npy"),
            np.stack(shard),
        )
        np.save(
            os.path.join(out_dir, f"labels_{n_shards:05d}.npy"),
            np.asarray(labels, np.int64),
        )
        np.save(
            os.path.join(out_dir, f"video_index_{n_shards:05d}.npy"),
            np.asarray(vidx, np.int32),
        )
        n_shards += 1
        shard, labels, vidx = [], [], []

    # BatchLoader parallelizes the decode when the dataset supports the
    # plan/load split; batch_size 1 keeps per-sample granularity.
    loader = BatchLoader(
        dataset, batch_size=1, num_workers=num_workers,
        collate_fn=lambda b: b, drop_last=False,
    )
    for samples in loader:
        for sample in samples:
            video = torch.as_tensor(sample["video"]).cpu().numpy()
            if video.ndim != 4 or video.shape[-1] != 3:
                raise ValueError(f"expected (T,H,W,3) clips, got {video.shape}")
            if t_h_w is None:
                t_h_w = video.shape[:3]
            elif tuple(video.shape[:3]) != tuple(t_h_w):
                raise ValueError(
                    f"clip shape {video.shape[:3]} != store shape {t_h_w}; "
                    "fix the dataset transform to a constant geometry"
                )
            clip = np.clip(video, 0, 255).astype(np.uint8)
            shard.append(clip)
            labels.append(int(torch.as_tensor(sample.get("label", -1))))
            vidx.append(int(torch.as_tensor(sample.get("video_index", -1))))
            total += 1
            if len(shard) >= clips_per_shard:
                flush()
    flush()

    if total == 0:
        raise ValueError(
            "prepare_clip_store: no clips were decoded from the dataset "
            "(every sample failed or the iterator was empty); refusing to "
            "write an unusable index.json"
        )

    index = {
        "version": 1,
        "num_clips": total,
        "num_shards": n_shards,
        "clip_shape": list(t_h_w) if t_h_w else None,
        "dtype": "uint8",
    }
    with open(os.path.join(out_dir, _INDEX), "w") as f:
        json.dump(index, f)
    return index


class ClipStore:
    """mmap-backed random access over a prepared store.

    ``np.load(mmap_mode="r")`` keeps the shards out of memory until
    touched; a batch is one copy of each clip from the page cache into the
    batch buffer, with no decode.
    """

    def __init__(self, store_dir: str):
        with open(os.path.join(store_dir, _INDEX)) as f:
            self.index = json.load(f)
        self._clips = []
        self._labels = []
        self._vidx = []
        for i in range(self.index["num_shards"]):
            self._clips.append(
                np.load(
                    os.path.join(store_dir, f"clips_{i:05d}.npy"),
                    mmap_mode="r",
                )
            )
            self._labels.append(
                np.load(os.path.join(store_dir, f"labels_{i:05d}.npy"))
            )
            self._vidx.append(
                np.load(os.path.join(store_dir, f"video_index_{i:05d}.npy"))
            )
        self._sizes = np.array([c.shape[0] for c in self._clips])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])
        self.num_clips = int(self._offsets[-1])
        self.clip_shape = tuple(self.index["clip_shape"])

    def __len__(self) -> int:
        return self.num_clips

    def gather(self, indices: np.ndarray, out: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """The batch of global clip ``indices`` (any order): "video" uint8
        (B, T, H, W, 3), "label" int64, "video_index" int32, CPU tensors.
        ``out(name, shape, dtype)`` hands the buffers to write into (the
        prefetch's pinned ring); by default new ones."""
        if out is None:
            def out(name, shape, dtype):
                return torch.empty(shape, dtype=dtype)
        n = len(indices)
        video = out("video", (n,) + self.clip_shape + (3,), torch.uint8)
        labels = out("label", (n,), torch.int64)
        vidx = out("video_index", (n,), torch.int32)
        video_np, labels_np, vidx_np = video.numpy(), labels.numpy(), vidx.numpy()
        shard_ids = np.searchsorted(self._offsets, indices, side="right") - 1
        for pos, (g, s) in enumerate(zip(indices, shard_ids)):
            local = g - self._offsets[s]
            video_np[pos] = self._clips[s][local]
            labels_np[pos] = self._labels[s][local]
            vidx_np[pos] = self._vidx[s][local]
        return {"video": video, "label": labels, "video_index": vidx}

    def batch_indices(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                      drop_last: bool = True, epochs: Optional[int] = 1) -> Iterator[np.ndarray]:
        """The clip indices of each batch of :meth:`batches`."""
        if drop_last and self.num_clips < batch_size:
            # would yield zero batches per epoch; with epochs=None the loop
            # would spin forever producing nothing
            raise ValueError(
                f"store holds {self.num_clips} clips < batch_size="
                f"{batch_size} with drop_last=True; no full batch exists"
            )
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(self.num_clips)
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            end = self.num_clips - self.num_clips % batch_size if drop_last else self.num_clips
            for i in range(0, end, batch_size):
                yield order[i:i + batch_size]
            epoch += 1

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, epochs: Optional[int] = 1
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield batch dicts; ``epochs=None`` streams forever (reshuffling
        each epoch from the seed + epoch counter), as the JAX store does."""
        for indices in self.batch_indices(batch_size, shuffle, seed, drop_last, epochs):
            yield self.gather(indices)

    def prefetch(self, batch_size: int, device="cuda", transform: Optional[Callable] = None,
                 **kwargs):
        """:meth:`batches` on ``device`` through ``device_prefetch``, each
        batch gathered straight into the prefetch's pinned ring
        (``gather=``); ``transform`` runs on the device in the prefetch's
        stream. ``kwargs`` as :meth:`batches`'."""
        from pytorchvideo_tpu_torch.data.loader import device_prefetch

        return device_prefetch(self.batch_indices(batch_size, **kwargs), device,
                               gather=self.gather, transform=transform)

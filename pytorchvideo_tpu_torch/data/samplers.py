"""Video-order samplers (counterpart of pytorchvideo_tpu/data/samplers.py):
iterables over video indices, ordered by numpy generators so that one seed
orders the videos as the JAX package does. ``torch.utils.data`` samplers
work wherever these are taken.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sized

import numpy as np


class SequentialSampler:
    def __init__(self, data_source: Sized):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self.data_source)))

    def __len__(self) -> int:
        return len(self.data_source)


class RandomSampler:
    """Uniform shuffle; seedable and re-seedable across epochs/workers."""

    def __init__(self, data_source: Sized, generator: Optional[np.random.Generator] = None):
        self.data_source = data_source
        self.generator = generator or np.random.default_rng()

    def manual_seed(self, seed: int):
        self.generator = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        return iter(
            self.generator.permutation(len(self.data_source)).tolist()
        )

    def __len__(self) -> int:
        return len(self.data_source)


class DistributedSampler:
    """Rank-sharded (optionally shuffled) index sampler, as torch's
    DistributedSampler: one rank's share of the videos, padded to equal
    shares unless ``drop_last``. Call ``set_epoch`` each epoch for a fresh
    shuffle."""

    def __init__(
        self,
        data_source: Sized,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.data_source = data_source
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        n = len(data_source)
        if drop_last and n % num_replicas != 0:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        n = len(self.data_source)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            # pad to make evenly divisible
            pad = self.total_size - len(indices)
            indices += indices[:pad]
        else:
            indices = indices[: self.total_size]
        return iter(indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples

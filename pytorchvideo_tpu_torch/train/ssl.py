"""SSL training utilities: KNN memory eval, momentum annealing, MoCo v2
(counterpart of pytorchvideo_tpu/train/ssl.py; upstream
pytorchvideo_trainer/module/ssl_helper.py KnnMemory :156, momentum annealing
:314-460, and module/moco_v2.py queue :408, batch shuffle :364-406).

The states live on the device: ``KnnMemory``'s bank, labels and pointer,
and ``MoCoV2``'s queue and pointer, each updated in place by index
arithmetic on the device, so a captured step writes them with no read back
to the host. MoCo's shuffle draws from the module's own generator
(``MoCoV2.generator``, on its device), which the captured step registers
with its graph, so each replay draws a new permutation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.models.byol import ema_, ema_tensors, l2_normalize, momentum_copy


def momentum_anneal_cosine(base_mmt: float, cur_epoch: float, max_epoch: float) -> float:
    """m_t = 1 - (1 - m) * (cos(pi * t / T) + 1) / 2."""
    return 1.0 - (1.0 - base_mmt) * (math.cos(math.pi * cur_epoch / max_epoch) + 1.0) / 2.0


class KnnMemory:
    """Feature bank and labels for online KNN evaluation (upstream
    ssl_helper.py:156-310). The state is a dict of device tensors,
    ``features`` (length, dim), ``labels`` (length,) int32 and ``ptr`` (0-d
    int64), which :meth:`update` writes in place and returns."""

    def __init__(self, length: int, dim: int, knn_k: int = 200, temperature: float = 1.0,
                 num_classes: int = 400):
        self.length, self.dim = length, dim
        self.knn_k, self.temperature, self.num_classes = knn_k, temperature, num_classes

    def init(self, generator: Optional[torch.Generator] = None,
             device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
        return {
            "features": torch.randn(self.length, self.dim, generator=generator,
                                    device=device) * 0.01,
            "labels": torch.zeros(self.length, dtype=torch.int32, device=device),
            "ptr": torch.zeros((), dtype=torch.long, device=device),
        }

    def update(self, state: Dict[str, torch.Tensor], features: torch.Tensor,
               labels: torch.Tensor, indices: Optional[torch.Tensor] = None):
        """Writes the normalised ``features`` at the dataset ``indices``, or
        ring-buffer style from the pointer (which then advances)."""
        features = l2_normalize(features)
        labels = labels.to(torch.int32)
        if indices is None:
            n = features.shape[0]
            indices = (state["ptr"] + torch.arange(n, device=features.device)) % self.length
            state["ptr"].copy_((state["ptr"] + n) % self.length)
        state["features"].index_copy_(0, indices, features.to(state["features"].dtype))
        state["labels"].index_copy_(0, indices, labels)
        return state

    def knn_predict(self, state: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
        """Weighted-KNN class scores (B, num_classes)."""
        features = l2_normalize(features)
        sims = features @ state["features"].T  # (B, length)
        topk_sims, topk_idx = torch.topk(sims, self.knn_k, dim=-1)
        topk_labels = state["labels"][topk_idx].long()  # (B, k)
        weights = torch.exp(topk_sims / self.temperature)
        one_hot = F.one_hot(topk_labels, self.num_classes).to(weights.dtype)
        return torch.einsum("bk,bkc->bc", weights, one_hot)


def shuffle_permutation(n: int, generator: Optional[torch.Generator] = None,
                        device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """A uniform random permutation of ``n`` on ``device``: the argsort of
    ``n`` uniform draws from ``generator`` (a CUDA graph holds it)."""
    return torch.argsort(torch.rand(n, generator=generator, device=device))


def batch_shuffle(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  perm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x[perm], the inverse permutation) (upstream moco_v2.py:364-386);
    ``perm`` drawn from ``generator`` unless given."""
    if perm is None:
        perm = shuffle_permutation(x.shape[0], generator, x.device)
    return x[perm], torch.argsort(perm)


def batch_unshuffle(x: torch.Tensor, inverse_perm: torch.Tensor) -> torch.Tensor:
    """Upstream moco_v2.py:388-406."""
    return x[inverse_perm]


class MoCoV2(nn.Module):
    """MoCo v2 around an online and a momentum encoder and a queue of
    negatives (upstream moco_v2.py). ``state_dict`` keys ``online.*``,
    ``momentum.*``, ``queue`` (queue_size, dim) and ``queue_ptr`` (0-d
    int64), the JAX state's. The queue starts as normalised normal draws
    from a generator seeded by ``seed``; the shuffle draws from
    ``self.generator``, on the queue's device, seeded by ``seed + 1``."""

    def __init__(self, backbone: nn.Module, queue_size: int = 65536, dim: int = 128,
                 temperature: float = 0.2, mmt: float = 0.994,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.online = backbone
        self.momentum = momentum_copy(backbone)
        self.queue_size, self.dim = queue_size, dim
        self.temperature, self.mmt = temperature, mmt
        generator = torch.Generator(device=device).manual_seed(seed)
        queue = torch.randn(queue_size, dim, generator=generator, device=device)
        self.register_buffer("queue", l2_normalize(queue))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long, device=device))
        self.generator = torch.Generator(device=device).manual_seed(seed + 1)

    def train(self, mode: bool = True):
        super().train(mode)
        self.momentum.eval()
        return self

    @torch.no_grad()
    def momentum_update(self, mmt=None) -> None:
        """momentum = momentum * mmt + online * (1 - mmt) over every float
        parameter and buffer (``mmt`` a float or a 0-d device tensor)."""
        ema_(ema_tensors(self.momentum), ema_tensors(self.online),
             self.mmt if mmt is None else mmt)

    @torch.no_grad()
    def dequeue_and_enqueue(self, keys: torch.Tensor) -> None:
        """Ring-buffer write of the normalised keys from the pointer, which
        advances (upstream moco_v2.py:408)."""
        n = keys.shape[0]
        idx = (self.queue_ptr + torch.arange(n, device=keys.device)) % self.queue_size
        self.queue.index_copy_(0, idx, l2_normalize(keys).to(self.queue.dtype))
        self.queue_ptr.copy_((self.queue_ptr + n) % self.queue_size)

    def loss(self, x_query: torch.Tensor,
             x_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """InfoNCE with the queue's negatives, the query through the online
        encoder in the module's mode, the key through the momentum encoder
        (eval mode) on the batch shuffled by a permutation drawn from
        ``self.generator``. Returns (loss, the normalised keys)."""
        q = l2_normalize(self.online(x_query))
        with torch.no_grad():
            x_shuffled, inverse = batch_shuffle(x_key, self.generator)
            k = l2_normalize(batch_unshuffle(self.momentum(x_shuffled), inverse))
        l_pos = (q * k).sum(-1, keepdim=True)
        l_neg = q @ self.queue.T
        logits = torch.cat([l_pos, l_neg], dim=1) / self.temperature
        return -F.log_softmax(logits, dim=-1)[:, 0].mean(), k

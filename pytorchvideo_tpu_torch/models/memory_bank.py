"""Memory-bank instance discrimination (https://arxiv.org/pdf/1805.01978.pdf);
counterpart of pytorchvideo_tpu/models/memory_bank.py (upstream
pytorchvideo/models/memory_bank.py:12-113).

The bank is the buffer ``memory`` (bank_size, dim) on the module's device;
``state_dict`` keys ``backbone.*``, ``mlp.*`` and ``memory``, the JAX
state's. The loss draws its negatives with a ``torch.Generator``
(:meth:`MemoryBank.draw_indices`) and :meth:`MemoryBank.loss_at` takes the
drawn indices, so a test can hand it the JAX package's draw. The bank
moves in place (an ``index_copy_``) where the JAX loss returns a new one.
At the defaults (1,280,000 x 2048 float32) the bank is 10.5 GB.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorchvideo_tpu_torch.models.byol import l2_normalize


class MemoryBank(nn.Module):
    def __init__(self, backbone: nn.Module, mlp: Optional[nn.Module] = None,
                 neg_size: int = 4096, temperature: float = 0.07, bank_size: int = 1280000,
                 dim: int = 2048, mmt: float = 0.999,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.backbone = backbone
        self.mlp = mlp
        self.neg_size, self.temperature = neg_size, temperature
        self.bank_size, self.dim, self.mmt = bank_size, dim, mmt
        self.register_buffer("memory", self.init_memory(generator, device))

    def init_memory(self, generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device] = "cuda") -> torch.Tensor:
        """Uniform in [-stdv, stdv), stdv = 1 / sqrt(dim / 3) (upstream :53-71)."""
        stdv = 1.0 / math.sqrt(self.dim / 3)
        memory = torch.empty(self.bank_size, self.dim, device=device)
        return memory.uniform_(-stdv, stdv, generator=generator)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.backbone(x)
        if self.mlp is not None:
            x = self.mlp(x)
        return l2_normalize(x)

    def draw_indices(self, x_ind: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, neg_size + 1) bank slots drawn uniformly with replacement,
        slot 0 of each row set to ``x_ind`` (the positive)."""
        idx = torch.randint(0, self.bank_size, (x_ind.shape[0], self.neg_size + 1),
                            generator=generator, device=self.memory.device)
        idx[:, 0] = x_ind
        return idx

    def loss_at(self, x: torch.Tensor, x_ind: torch.Tensor, idx: torch.Tensor,
                train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The contrastive loss of ``x`` against the bank rows ``idx`` (B,
        K + 1), the positive in column 0; with ``train`` the rows ``x_ind``
        move to l2n(row * mmt + embedding * (1 - mmt)). Returns (loss, the
        bank)."""
        emb = self.embed(x)
        weight = self.memory[idx]  # (B, K + 1, C)
        logits = torch.einsum("bkc,bc->bk", weight, emb) / self.temperature
        loss = -F.log_softmax(logits, dim=-1)[:, 0].mean()
        if train:
            with torch.no_grad():
                pos = self.memory[x_ind]
                updated = l2_normalize(pos * self.mmt + emb.detach() * (1 - self.mmt))
                self.memory.index_copy_(0, x_ind, updated)
        return loss, self.memory

    def loss(self, x: torch.Tensor, x_ind: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`loss_at` at indices drawn from ``generator``."""
        return self.loss_at(x, x_ind, self.draw_indices(x_ind, generator), train)

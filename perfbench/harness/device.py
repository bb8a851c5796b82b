"""The device a run measures: one or more NVIDIA cards (:class:`Card`).

A run finds the cards it asks for or fails; it never falls back to the
CPU. :class:`Host` stands in for the card only in the tests, which drive
a whole run on the CPU at a small size: it captures nothing, pins nothing
and reads no device memory."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


class Card:
    platform = "gpu"

    def __init__(self, chips: int):
        if chips != 1:
            # Every kind places its work on one card; a kind that spreads it
            # over several brings its own placement with the count it reports.
            raise NoCard(f"the cell asks for {chips} cards; the benchmark's kinds run on one")
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false: this benchmark runs on NVIDIA cards")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell asks for {chips} cards, torch sees "
                         f"{torch.cuda.device_count()}")
        self.chips = chips
        self.device = torch.device("cuda", 0)
        torch.cuda.set_device(self.device)
        self.kind = torch.cuda.get_device_name(self.device)

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def default_generator(self) -> torch.Generator:
        """The generator the program draws from where it names none."""
        return torch.cuda.default_generators[self.device.index]

    def pinned(self, t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory()

    def capture(self, module, example):
        """The program's compiled serving of ``module`` at ``example``'s shape."""
        from pytorchvideo_tpu_torch.accelerate.deploy import CompiledForward

        return CompiledForward(module, example)

    def activities(self):
        return [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def free(self) -> None:
        torch.cuda.empty_cache()

    def power_limit(self) -> str:
        """nvidia-smi's name and power limit of the card ('' where it fails)."""
        try:
            proc = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return ""
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout else ""


class _Eager:
    """The module itself in place of a captured forward (tests on the CPU)."""

    def __init__(self, module):
        self.module = module

    def __call__(self, x):
        with torch.no_grad():
            return self.module(x)


class Host:
    """The CPU in place of the card, for tests only."""

    platform = "cpu"
    kind = "cpu"

    def __init__(self, chips: int = 1):
        self.chips = chips
        self.device = torch.device("cpu")

    def sync(self) -> None:
        pass

    def peak_bytes(self) -> int:
        return 0

    def default_generator(self) -> torch.Generator:
        return torch.default_generator

    def pinned(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def capture(self, module, example):
        return _Eager(module)

    def activities(self):
        return [torch.profiler.ProfilerActivity.CPU]

    def free(self) -> None:
        pass

    def power_limit(self) -> str:
        return ""

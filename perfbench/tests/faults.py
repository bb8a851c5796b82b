"""Faults planted in the program underneath a run, each of which the run's
comparison with the reference has to catch (``correct`` false). Each is
Python source run in the run's process before the run."""

# Every answer altered where it is produced: the classifier's logits
# shifted by one class (the compiled forward on the card, the head's
# forward in the eager form on the CPU).
ANSWER_ALTERED_CARD = """
from pytorchvideo_tpu_torch.accelerate import deploy as _deploy
_call = _deploy.CompiledForward.__call__
_deploy.CompiledForward.__call__ = lambda self, x: _call(self, x).roll(1, dims=-1)
"""
ANSWER_ALTERED_HOST = """
from pytorchvideo_tpu_torch.models import head as _head
for _cls in (_head.ResNetBasicHead, _head.VisionTransformerBasicHead):
    def _broken(self, x, _forward=_cls.forward):
        return _forward(self, x).roll(1, dims=-1)
    _cls.forward = _broken
"""
# A step that returns its state unchanged: the optimizer never updates.
STATE_UNCHANGED = """
import torch as _torch
_torch.optim.AdamW.step = lambda self, closure=None: None
"""
# Half of the batch left out, the mean taken over the rest.
HALF_BATCH = """
from pytorchvideo_tpu_torch.train import train_loop as _loop
_update = _loop.TrainStep.update
def _half(self, state, video, labels):
    n = labels.shape[0] // 2
    return _update(self, state, video[:n], labels[:n])
_loop.TrainStep.update = _half
"""

# Faults of the captured step's replays alone (no replay runs on the CPU).
# The static input buffers not refreshed after the capture: every replay
# steps on the batch and mix the capture saw.
STALE_INPUTS = """
from pytorchvideo_tpu_torch.train import compiled_step as _cs
_call = _cs.CompiledTrainStep.__call__
def _stale(self, state, batch, generator=None, **scalars):
    if self.graph is None:
        return _call(self, state, batch, generator, **scalars)
    static, self._static = self._static, [[t.clone() for t in s] for s in self._static]
    try:
        return _call(self, state, batch, generator, **scalars)
    finally:
        self._static = static
_cs.CompiledTrainStep.__call__ = _stale
"""
# The optimizer's moments frozen on a replay: the parameters move, the
# moments stay as they were before it.
STATE_FROZEN_ON_REPLAY = """
from pytorchvideo_tpu_torch.train import compiled_step as _cs
_call = _cs.CompiledTrainStep.__call__
def _frozen(self, state, batch, generator=None, **scalars):
    if self.graph is None:
        return _call(self, state, batch, generator, **scalars)
    kept = [(t, t.clone()) for s in state.optimizer.state.values() for k, t in s.items()
            if k in ("exp_avg", "exp_avg_sq")]
    out = _call(self, state, batch, generator, **scalars)
    for t, saved in kept:
        t.copy_(saved)
    return out
_cs.CompiledTrainStep.__call__ = _frozen
"""

SERVE_FAULTS = {"answer_altered": (ANSWER_ALTERED_CARD, ANSWER_ALTERED_HOST)}
TRAIN_FAULTS = {"state_unchanged": (STATE_UNCHANGED, STATE_UNCHANGED),
                "half_batch": (HALF_BATCH, HALF_BATCH)}
REPLAY_FAULTS = {"stale_inputs": (STALE_INPUTS, None),
                 "state_frozen_on_replay": (STATE_FROZEN_ON_REPLAY, None)}

"""Deployable form: the port's serving model, its compiled serving and its export.

Counterpart of pytorchvideo_tpu/accelerate/deploy.py
``convert_to_deployable_form``, which folds BN, casts to bf16 and AOT-compiles
the JAX forward, and of its ``export_stablehlo``. Here the conversion
rewrites a copy of the module tree in three passes, the ``"cuda"`` target of
the transmuter (accelerate/transmuter.py), which runs them:

- :func:`fold_bn_pass`: every conv+BN pair is folded (accelerate/fuse.py); a
  BN after anything else (the acoustic stem's ``ConvReduce3D``) stays, in
  eval mode;
- :func:`kernel_pass`: each stride-1 depthwise 3x3x3 ``conv_b`` of a
  bottleneck whose BN folded into it (X3D's, and CSN's) becomes
  :class:`DepthwiseConv3x3x3BnAct`, one call of the fused kernel
  (ops/depthwise_conv.py). X3D's swish runs in the kernel's epilogue where
  the block has no SE; otherwise the kernel applies the folded bias only,
  and what follows (SE and swish, CSN's ReLU) stays plain torch. The
  efficient blocks of accelerate/conv_blocks.py take the same swap through
  their ``swap_in_kernel``. Strided ``conv_b``, and grouped convs that are
  not depthwise, stay ``F.conv3d``: the kernel, as the TPU's, computes
  stride 1 only;
- :func:`cast_pass`: weights are cast to ``dtype``.

With ``fold_bn=False`` the BNs stay as they are, and so does every
``conv_b`` (the kernel takes a conv only with its BN folded into it). A
LayerNorm MViT has no BN to fold, so its deploy form is the eval model
with weights in ``dtype``; its token pools and attention run on their
kernels in every form (layers/attention.py). The BatchNorm MViT folds its
norms with ``fuse_bn_mvit`` (accelerate/fuse.py) before it is converted, as
in the JAX package.

Without ``example_input`` the result is that module, run eagerly: it takes
NCTHW input of ``dtype`` (SlowFast: a list ``[slow, fast]``, each cast by the
caller). With ``example_input`` (on the card only) it is a
:class:`CompiledForward`, the counterpart of the JAX package's AOT-compiled
executable: the eager deploy module's forward captured once in a CUDA graph
at that input's shape and dtype, which each call replays.

:func:`export_program`, the counterpart of ``export_stablehlo``, serializes a
deploy form with ``torch.export``. Every kernel call of the forward is one
node of the ``pvt`` custom-op namespace in the program (the ops' dispatchers
call ``torch.ops.pvt.*`` under tracing), so the loaded program launches the
hand-written kernels on CUDA tensors and their plain versions on CPU tensors.
Loading needs ``torch.export.load`` and an import of ``pytorchvideo_tpu_torch``,
which registers the ops.
"""

from __future__ import annotations

import io
import time
from typing import List, Optional, Union

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm

from pytorchvideo_tpu_torch.accelerate.fuse import fold_conv_bn
from pytorchvideo_tpu_torch.layers.stochastic import Swish
from pytorchvideo_tpu_torch.models.resnet import BottleneckBlock
from pytorchvideo_tpu_torch.ops import launch_counts, launches_since
from pytorchvideo_tpu_torch.ops.depthwise_conv import depthwise3x3x3_bn_swish
from pytorchvideo_tpu_torch.utils.profiling import annotate, count


class DepthwiseConv3x3x3BnAct(nn.Module):
    """Depthwise 3x3x3 conv, stride 1, pad 1, with a folded-BN bias and an
    optional swish, through ``depthwise3x3x3_bn_swish``.

    ``weight`` is (3, 3, 3, C), the kernel's layout; ``bias`` is (C,).
    Takes and returns NCTHW tensors in ``torch.channels_last_3d``."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, apply_swish: bool):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().contiguous(), requires_grad=False)
        self.bias = nn.Parameter(bias.detach().contiguous(), requires_grad=False)
        self.apply_swish = apply_swish

    @classmethod
    def from_folded_conv(cls, conv: nn.Conv3d, apply_swish: bool):
        """From a depthwise conv whose bias holds the folded BN shift."""
        weight = conv.weight[:, 0].permute(1, 2, 3, 0)  # (C, 1, 3, 3, 3) -> (3, 3, 3, C)
        return cls(weight, conv.bias, apply_swish)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last_3d).permute(0, 2, 3, 4, 1)
        y = depthwise3x3x3_bn_swish(x, self.weight, None, self.bias, self.apply_swish)
        return y.permute(0, 4, 1, 2, 3)

    def extra_repr(self) -> str:
        return f"channels={self.weight.shape[-1]}, apply_swish={self.apply_swish}"


def _is_kernel_conv(conv: nn.Module) -> bool:
    """A depthwise 3x3x3 conv with stride 1 and padding 1: what the kernel computes."""
    return (
        isinstance(conv, nn.Conv3d)
        and conv.in_channels == conv.out_channels == conv.groups
        and conv.kernel_size == (3, 3, 3)
        and conv.stride == (1, 1, 1)
        and conv.padding == (1, 1, 1)
        and conv.dilation == (1, 1, 1)
        and conv.padding_mode == "zeros"
    )


def _folded_norm_b(block: BottleneckBlock) -> bool:
    """conv_b holds its BN as a bias: norm_b is None (folded or never there),
    or X3D's Sequential(Identity, SE or Identity)."""
    norm_b = block.norm_b
    return block.conv_b.bias is not None and (
        norm_b is None
        or (isinstance(norm_b, nn.Sequential) and len(norm_b) == 2
            and isinstance(norm_b[0], nn.Identity)))


def _swap_in_kernel(block: BottleneckBlock) -> None:
    """Replace a folded block's conv_b (+ the BN folded into it) by the
    kernel; swish joins the kernel's epilogue where no SE comes between."""
    se = nn.Identity() if block.norm_b is None else block.norm_b[1]
    has_se = not isinstance(se, nn.Identity)
    fuse_swish = not has_se and isinstance(block.act_b, (Swish, nn.SiLU))
    block.conv_b = DepthwiseConv3x3x3BnAct.from_folded_conv(block.conv_b, fuse_swish)
    block.norm_b = se if has_se else None
    if fuse_swish:
        block.act_b = None


def fold_bn_pass(model: nn.Module, fold_bn: bool = True, **kwargs) -> Optional[nn.Module]:
    """Folds every conv+BN pair of an eval-mode ``model`` in place; None (no
    change) where ``fold_bn`` is off or the model holds no BN."""
    if not fold_bn or not any(isinstance(m, _BatchNorm) for m in model.modules()):
        return None
    return fold_conv_bn(model)


def kernel_pass(model: nn.Module, **kwargs) -> Optional[nn.Module]:
    """Puts each stride-1 depthwise 3x3x3 conv whose BN folded into it on
    the kernel, in place: a bottleneck's ``conv_b``, and the convs of the
    modules that define ``swap_in_kernel`` (the efficient blocks). None
    where nothing was swapped."""
    swapped = 0
    for block in list(model.modules()):
        if (isinstance(block, BottleneckBlock) and _is_kernel_conv(block.conv_b)
                and _folded_norm_b(block)):
            _swap_in_kernel(block)
            swapped += 1
        elif callable(getattr(block, "swap_in_kernel", None)):
            swapped += block.swap_in_kernel()
    return model if swapped else None


def cast_pass(model: nn.Module, dtype: Optional[torch.dtype] = torch.bfloat16,
              **kwargs) -> Optional[nn.Module]:
    """Casts the weights to ``dtype``; None keeps them."""
    return None if dtype is None else model.to(dtype)


Clip = Union[torch.Tensor, List[torch.Tensor]]
# Eager forwards on a side stream before a capture: the first builds and
# loads the kernels' library (nvcc), cuDNN and cuBLAS set up their handles,
# algorithms and workspaces; none of that may happen inside a capture.
WARMUP_FORWARDS = 2


def _tensors(x: Clip) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class CompiledForward:
    """A deploy module's forward captured in one ``torch.cuda.CUDAGraph`` at
    one input's shape and dtype: the counterpart of the JAX package's
    executable compiled for one input shape.

    ``module`` is the eager deploy form (kept as ``.module``); ``example_input``
    an NCTHW CUDA clip batch, or a list of them for SlowFast's pathways (one
    static buffer each). The forward runs ``WARMUP_FORWARDS`` times eagerly on
    a side stream, then is captured under ``torch.no_grad()`` in the memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``; default: a new one, kept
    as ``.pool``). Graphs of one module at several batches share one pool
    by passing it on: ``CompiledForward(c.module, x8, pool=c.pool)``; they
    must not be replayed concurrently.

    A call copies the input into the static buffers, replays the graph and
    returns a clone of the static output, so no returned tensor is
    overwritten by the next call. An input of another shape, dtype or device
    (or another number of pathways) raises ValueError: nothing is captured
    again, as the JAX executable rejects a mismatched argument.

    The graph reads the parameters at their addresses: an in-place edit of
    ``.module``'s parameters takes effect at the next replay, and rebinding
    a parameter to a new tensor does not. The JAX package's baked weights,
    and its guard against a foreign variables tree, have no counterpart.
    The kernels' launch counters move while the forward is captured (and
    warmed up), never on a replay, which runs no Python. The program's
    counters (utils/profiling.py) count the capture in ``serve.captures``
    and each replay in ``serve.replays``; ``.launches_per_replay`` holds the
    launches the capture made by kernel (ops ``launch_counts``), so replays
    times it gives the launches the replays made. ``.capture_s``: the host
    seconds of the warm-up forwards and the capture (the capture begins by
    waiting for the card, so the warm-ups' device time is in it).

    Spans: ``pvt.serve.capture`` around the warm-ups and the capture;
    ``pvt.serve.call`` around a call, with ``pvt.serve.copy_in``,
    ``pvt.serve.replay`` and ``pvt.serve.clone`` inside.
    """

    def __init__(self, module: nn.Module, example_input: Clip, pool=None):
        inputs = _tensors(example_input)
        device = inputs[0].device
        _require_card(module, inputs)
        self.module = module
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._as_list = isinstance(example_input, (list, tuple))
        # Allocated before the capture, outside the graph's pool.
        self._static_in = [t.detach().clone() for t in inputs]
        arg = self._static_in if self._as_list else self._static_in[0]
        start = time.perf_counter()
        with annotate("pvt.serve.capture"), torch.cuda.device(device), torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FORWARDS):
                    module(arg)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            launches = launch_counts()
            # Thread-local: a data prefetch's thread (its event waits and
            # pinned allocations) may run beside the capture.
            with torch.cuda.graph(self.graph, pool=self.pool, capture_error_mode="thread_local"):
                out = module(arg)
        self.capture_s = time.perf_counter() - start
        self.launches_per_replay = launches_since(launches)
        count("serve.captures")
        if not isinstance(out, torch.Tensor):
            raise ValueError(f"the deploy form must return one tensor, got {type(out).__name__}")
        self._static_out = out

    def __call__(self, x: Clip) -> torch.Tensor:
        with annotate("pvt.serve.call"):
            inputs = _tensors(x)
            expected = [(t.shape, t.dtype, t.device) for t in self._static_in]
            got = [(t.shape, t.dtype, t.device) for t in inputs]
            if isinstance(x, (list, tuple)) != self._as_list or got != expected:
                raise ValueError(f"this forward was captured for {_describe(expected)}, got "
                                 f"{_describe(got)}")
            with annotate("pvt.serve.copy_in"):
                for static, t in zip(self._static_in, inputs):
                    static.copy_(t)
            with annotate("pvt.serve.replay"):
                self.graph.replay()
            count("serve.replays")
            with annotate("pvt.serve.clone"):
                return self._static_out.clone()


def _describe(specs) -> str:
    return ", ".join(f"{tuple(shape)} {dtype} on {device}" for shape, dtype, device in specs)


def _require_card(module: nn.Module, inputs: List[torch.Tensor]) -> None:
    """Compiled serving captures a CUDA graph: it needs the model and its
    input on one CUDA device. There is no eager fallback."""
    devices = {t.device for t in inputs} | {p.device for p in module.parameters()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"compiled serving (example_input) needs the card: the model and its input on one "
            f"CUDA device, got {sorted(map(str, devices))}; on the CPU use the eager deploy form "
            f"(no example_input) or export_program")


def convert_to_deployable_form(
    model: nn.Module, dtype: Optional[torch.dtype] = torch.bfloat16,
    example_input: Optional[Clip] = None, fold_bn: bool = True,
) -> Union[nn.Module, CompiledForward]:
    """Returns the deploy form of ``model`` (which is left unchanged): BN
    folded, stride-1 depthwise 3x3x3 ``conv_b`` on the fused kernel, weights
    in ``dtype`` (``None`` keeps them), in eval mode: the transmuter's
    ``"cuda"`` passes (:func:`fold_bn_pass`, :func:`kernel_pass`,
    :func:`cast_pass`). ``fold_bn=False`` leaves every BN and every conv
    as they are. Call it on NCTHW input of that dtype, on the device the
    model was moved to.

    With ``example_input`` (a CUDA clip batch, or SlowFast's list of them,
    cast to ``dtype``), returns that module's :class:`CompiledForward` at the
    input's shape; a model or input off the card raises ValueError."""
    from pytorchvideo_tpu_torch.accelerate.transmuter import transmute_model

    if example_input is not None:
        _require_card(model, _tensors(example_input))
    model = transmute_model(model, "cuda", dtype=dtype, fold_bn=fold_bn)
    if example_input is None:
        return model
    example = [t.to(dtype or t.dtype) for t in _tensors(example_input)]
    return CompiledForward(model, example if isinstance(example_input, (list, tuple))
                           else example[0])


def export_program(model: nn.Module, example_input: Clip) -> bytes:
    """Serializes ``model`` (a deploy form) for ``example_input``'s shapes:
    ``torch.export.export`` under ``torch.no_grad()``, then
    ``torch.export.save``. Each kernel call is one ``pvt::`` node, never its
    plain version decomposed. Load with ``torch.export.load`` after importing
    ``pytorchvideo_tpu_torch`` and call ``.module()`` of the result."""
    with torch.no_grad():
        program = torch.export.export(model, (example_input,))
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()

"""Plain float32 X3D (Feichtenhofer, "X3D: Expanding Architectures for
Efficient Video Recognition", arXiv:2004.04730; pytorchvideo's
``create_x3d``), written from the published description with
``torch.nn.functional`` alone.

The configuration's ``model`` holds the factors the paper expands by
(``width_factor``, ``depth_factor``, ``bottleneck_factor``, the clip),
which are also the keywords of the program's factory. The stem is a 1x3x3
conv then a depthwise 5x1x1 conv; each stage's first block strides 2 in
space and projects its shortcut; each block is 1x1x1 -> depthwise 3x3x3
(+ squeeze-excitation on every other block) + swish -> 1x1x1, BN after
each conv; the head is 1x1x1 conv, BN, ReLU, average pool over the whole
13x5x5 grid, 1x1x1 conv to 2048, ReLU, and a linear classifier. BN runs in
eval mode from its running statistics.

Leaves carry the program's ``state_dict`` names (upstream pytorchvideo's),
so one seeded dict is handed to both sides. The running statistics are set
by :func:`make_weights` from one forward of the reference itself over
seeded calibration clips (batch statistics), as precise BN would set them:
with arbitrary statistics the 26 residual blocks compound activations to
~1e5. Gains of each block's last BN lie in [0.2, 0.4], the others' in
[0.5, 1.5], so no branch vanishes and none dominates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.harness.weights import draw
from perfbench.reference.common import (exact_float32, forward_flops, lowp, round_repeats,
                                        round_width)

BN_EPS = 1e-5
CALIBRATION_CLIPS = 2


def architecture(model: dict) -> dict:
    """Sizes derived from the configuration's factors, as the paper's
    expansion rules give them."""
    width, depth = model.get("width_factor", 2.0), model.get("depth_factor", 2.2)
    stem_dim_in = model.get("stem_dim_in", 12)
    dims = [stem_dim_in]
    for _ in range(3):
        dims.append(round_width(dims[-1], 2.0, divisor=8))
    stages, dim_in = [], round_width(stem_dim_in, width)
    for idx, depth_base in enumerate((1, 2, 5, 3)):
        dim_out = round_width(dims[idx], width)
        dim_inner = int(model.get("bottleneck_factor", 2.25) * dim_out)
        stages.append({"depth": round_repeats(depth_base, depth), "dim_in": dim_in,
                       "dim_inner": dim_inner, "dim_out": dim_out,
                       "se": round_width(dim_inner, model.get("se_ratio", 0.0625))})
        dim_in = dim_out
    clip = (model["input_clip_length"], model["input_crop_size"], model["input_crop_size"])
    return {"stem_dim": round_width(stem_dim_in, width), "stages": stages, "clip": clip,
            "head_inner": stages[-1]["dim_inner"], "head_dim": model.get("head_dim_out", 2048),
            "num_classes": model.get("model_num_class", 400),
            "head_pool": (clip[0], clip[1] // 32, clip[2] // 32)}


def _bn(specs, name, c, last=False):
    low, high = (0.2, 0.4) if last else (0.5, 1.5)
    specs += [(f"{name}.weight", (c,), ("uniform", low, high)),
              (f"{name}.bias", (c,), ("normal", 0.1)),
              (f"{name}.running_mean", (c,), ("const", 0.0)),
              (f"{name}.running_var", (c,), ("const", 1.0))]


def _conv(specs, name, shape, bias=False):
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    specs.append((f"{name}.weight", shape, ("normal", (2.0 / fan_in) ** 0.5)))
    if bias:
        specs.append((f"{name}.bias", (shape[0],), ("normal", 0.1)))


def blocks(arch: dict):
    """(prefix, stage, index, dim_in, stride) of every bottleneck block."""
    for s, st in enumerate(arch["stages"]):
        for i in range(st["depth"]):
            yield (f"blocks.{s + 1}.res_blocks.{i}", st, i,
                   st["dim_in"] if i == 0 else st["dim_out"], 2 if i == 0 else 1)


def weight_specs(model: dict) -> List[tuple]:
    arch = architecture(model)
    c0, specs = arch["stem_dim"], []
    _conv(specs, "blocks.0.conv.conv_t", (c0, 3, 1, 3, 3))
    _conv(specs, "blocks.0.conv.conv_xy", (c0, 1, 5, 1, 1))
    _bn(specs, "blocks.0.norm", c0)
    for prefix, st, i, dim_in, stride in blocks(arch):
        inner, out = st["dim_inner"], st["dim_out"]
        if i == 0:
            _conv(specs, f"{prefix}.branch1_conv", (out, dim_in, 1, 1, 1))
            if dim_in != out:
                _bn(specs, f"{prefix}.branch1_norm", out)
        b = f"{prefix}.branch2"
        _conv(specs, f"{b}.conv_a", (inner, dim_in, 1, 1, 1))
        _bn(specs, f"{b}.norm_a", inner)
        _conv(specs, f"{b}.conv_b", (inner, 1, 3, 3, 3))
        _bn(specs, f"{b}.norm_b.0", inner)
        if i % 2 == 0:
            _conv(specs, f"{b}.norm_b.1.block.0", (st["se"], inner, 1, 1, 1), bias=True)
            _conv(specs, f"{b}.norm_b.1.block.2", (inner, st["se"], 1, 1, 1), bias=True)
        _conv(specs, f"{b}.conv_c", (out, inner, 1, 1, 1))
        _bn(specs, f"{b}.norm_c", out, last=True)
    h = f"blocks.{len(arch['stages']) + 1}"
    _conv(specs, f"{h}.pool.pre_conv", (arch["head_inner"], arch["stages"][-1]["dim_out"], 1, 1, 1))
    _bn(specs, f"{h}.pool.pre_norm", arch["head_inner"])
    _conv(specs, f"{h}.pool.post_conv", (arch["head_dim"], arch["head_inner"], 1, 1, 1))
    specs += [(f"{h}.proj.weight", (arch["num_classes"], arch["head_dim"]),
               ("normal", (1.0 / arch["head_dim"]) ** 0.5)),
              (f"{h}.proj.bias", (arch["num_classes"],), ("normal", 0.1))]
    return specs


class _Forward:
    """One forward over a weight dict; ``calibrate`` sets each BN's running
    statistics to its batch's (mean, biased variance) on the way."""

    def __init__(self, w: Dict[str, torch.Tensor], model: dict, calibrate=False, control=None):
        self.w, self.arch, self.calibrate, self.control = w, architecture(model), calibrate, control

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w = self.w[f"{name}.weight"]
        return F.conv3d(lowp(x, self.control), lowp(w, self.control), self.w.get(f"{name}.bias"),
                        stride, padding, 1, groups)

    def bn(self, x, name):
        if self.calibrate:
            with torch.no_grad():
                self.w[f"{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3, 4)))
                self.w[f"{name}.running_var"].copy_(x.var(dim=(0, 2, 3, 4), unbiased=False))
        shape = (1, -1, 1, 1, 1)
        mean = self.w[f"{name}.running_mean"].view(shape)
        var = self.w[f"{name}.running_var"].view(shape)
        return ((x - mean) * torch.rsqrt(var + BN_EPS) * self.w[f"{name}.weight"].view(shape)
                + self.w[f"{name}.bias"].view(shape))

    def __call__(self, x):
        arch = self.arch
        x = self.conv(x, "blocks.0.conv.conv_t", (1, 2, 2), (0, 1, 1))
        x = self.conv(x, "blocks.0.conv.conv_xy", 1, (2, 0, 0), groups=arch["stem_dim"])
        x = F.relu(self.bn(x, "blocks.0.norm"))
        for prefix, st, i, dim_in, stride in blocks(arch):
            b = f"{prefix}.branch2"
            shortcut = x
            if i == 0:
                shortcut = self.conv(x, f"{prefix}.branch1_conv", (1, stride, stride))
                if dim_in != st["dim_out"]:
                    shortcut = self.bn(shortcut, f"{prefix}.branch1_norm")
            y = F.relu(self.bn(self.conv(x, f"{b}.conv_a"), f"{b}.norm_a"))
            y = self.conv(y, f"{b}.conv_b", (1, stride, stride), 1, groups=st["dim_inner"])
            y = self.bn(y, f"{b}.norm_b.0")
            if i % 2 == 0:
                s = y.mean(dim=(2, 3, 4), keepdim=True)
                s = F.relu(self.conv(s, f"{b}.norm_b.1.block.0"))
                y = y * torch.sigmoid(self.conv(s, f"{b}.norm_b.1.block.2"))
            y = y * torch.sigmoid(y)  # swish
            y = self.bn(self.conv(y, f"{b}.conv_c"), f"{b}.norm_c")
            x = F.relu(shortcut + y)
        h = f"blocks.{len(arch['stages']) + 1}"
        x = F.relu(self.bn(self.conv(x, f"{h}.pool.pre_conv"), f"{h}.pool.pre_norm"))
        x = F.avg_pool3d(x, arch["head_pool"], stride=1)
        x = F.relu(self.conv(x, f"{h}.pool.post_conv"))
        x = x.permute(0, 2, 3, 4, 1)
        x = F.linear(lowp(x, self.control), lowp(self.w[f"{h}.proj.weight"], self.control),
                     self.w[f"{h}.proj.bias"])
        return x.mean(dim=(1, 2, 3))


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
            control: Optional[torch.dtype] = None) -> torch.Tensor:
    """Logits (B, classes) of NCTHW clips ``x`` (normalised), in x's dtype;
    with ``control`` every conv's and the classifier's operands are
    rounded to that precision first."""
    return _Forward(w, model, control=control)(x)


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded leaves, with BN statistics from the batch statistics of
    ``CALIBRATION_CLIPS`` seeded clips (uniform frames, normalised as
    served), and each BN's ``num_batches_tracked``."""
    w = draw(weight_specs(model), seed, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) + 1)
    clips = torch.rand((CALIBRATION_CLIPS, 3) + tuple(architecture(model)["clip"]),
                       generator=generator, device=device)
    with torch.no_grad(), exact_float32():
        _Forward(w, model, calibrate=True)((clips - 0.45) / 0.225)
    for name in [k for k in w if k.endswith(".running_var")]:
        w[name[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=w[name].device)
    return w


def flops_per_clip(model: dict) -> float:
    """The forward's FLOPs for one clip (2 a multiply-add)."""
    return forward_flops(lambda w, x: forward(w, x, model), weight_specs(model),
                         (1, 3) + tuple(architecture(model)["clip"]))


def conv_b_work(in_shape: Tuple[int, ...], out_shape: Tuple[int, ...], itemsize: int):
    """(FLOPs, bytes) of one block's conv_b stage (depthwise 3x3x3 conv,
    its folded BN's bias, and the swish where it runs in the stage) on
    NCTHW ``in_shape`` -> ``out_shape``: 2 a multiply-add of the 27 taps
    per output element; the input read once, the output written once, the
    27 taps and the bias of each channel once."""
    c = out_shape[1]
    out = 1
    for s in out_shape:
        out *= s
    inp = 1
    for s in in_shape:
        inp *= s
    return 2.0 * 27 * out, float(itemsize * (inp + out + 28 * c))

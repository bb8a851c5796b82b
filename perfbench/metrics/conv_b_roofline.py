"""The conv_b stage of every X3D bottleneck block against its roofline, in %.

The unit is what the stage computes: the depthwise 3x3x3 conv, its folded
BN and, where the block has no squeeze-excitation, the swish. In the deploy
form the range runs from the block's ``conv_b`` to its ``act_b`` where
that follows the conv directly (no SE in ``norm_b``), else over ``conv_b``
alone, so the fused kernel (#1, swish in its epilogue), cuDNN's strided
depthwise convs, or whatever a later change puts there, read alike. Work
from each unit's shapes (reference ``conv_b_work``); time from the
kernels launched in its range."""

from perfbench.harness.units import profile_units, roofline_share


def units(module):
    found = []
    for name, block in module.named_modules():
        conv = getattr(block, "conv_b", None)
        if conv is None or not hasattr(block, "act_b"):
            continue
        last = conv
        if block.act_b is not None and block.norm_b is None:
            last = block.act_b
        found.append((name, conv, last))
    return found


def read(run):
    found = units(run.program["module"])
    run.note(f"conv_b_roofline: {len(found)} units")
    measured = profile_units(run.device, run.program["module"], run.program["example"], found,
                             run.traffic["unit_forwards"])

    def work(unit):
        (in_shape, itemsize), = unit["inputs"]
        out_shape, _ = unit["outputs"]
        return run.reference.conv_b_work(in_shape, out_shape, itemsize)

    return roofline_share(run, measured, work)

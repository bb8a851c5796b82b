"""The attention of every MViT block against its roofline, in %.

The unit is each block's ``attn``: the q, k and v projections, the pools
and their norms, the attention of every head and the output projection,
whichever kernels (#4, #6, cuBLAS, LayerNorm, or what a later change puts
there) compute them. Work from each unit's shapes (reference
``attention_work``); time from the kernels launched in its range."""

from perfbench.harness.units import profile_units, roofline_share


def read(run):
    module = run.program["module"]
    found = [(f"blocks.{i}.attn", block.attn, block.attn) for i, block in enumerate(module.blocks)]
    measured = profile_units(run.device, module, run.program["example"], found,
                             run.traffic["unit_forwards"])

    def work(unit):
        i = int(unit["name"].split(".")[1])
        ((_, (grid, itemsize)), thw) = unit["inputs"]
        flops, nbytes, q_thw = run.reference.attention_work(run.model, i, grid[0], thw, itemsize)
        if tuple(unit["outputs"][1]) != tuple(q_thw):
            raise ValueError(f"{unit['name']}: the program's output grid {unit['outputs'][1]} "
                             f"is not the reference's {q_thw}")
        return flops, nbytes

    return roofline_share(run, measured, work)

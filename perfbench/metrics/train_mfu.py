"""The training step's share of the card's bf16 peak: clips in the window
times 3 x the reference's forward FLOPs a clip (a forward, and a backward
of twice the forward), over the window's seconds and 989 TFLOP/s, in %."""

from perfbench.harness.peaks import PEAK_BF16_FLOPS


def read(run):
    flops = 3.0 * run.reference.flops_per_clip(run.model)
    run.note(f"train_mfu: {flops!r} FLOPs a clip, {run.window['clips']} clips in "
             f"{run.window['seconds']!r} s")
    return 100.0 * run.window["clips"] * flops / run.window["seconds"] / PEAK_BF16_FLOPS

"""The served path's share of the card's bf16 peak: clips answered in the
window times the reference's forward FLOPs a clip (FlopCounterMode, 2 a
multiply-add), over the window's seconds and 989 TFLOP/s, in %."""

from perfbench.harness.peaks import PEAK_BF16_FLOPS


def read(run):
    flops = run.reference.flops_per_clip(run.model)
    run.note(f"serve_mfu: {flops!r} FLOPs a clip, {run.window['clips']} clips in "
             f"{run.window['seconds']!r} s")
    return 100.0 * run.window["clips"] * flops / run.window["seconds"] / PEAK_BF16_FLOPS

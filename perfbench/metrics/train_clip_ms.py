"""Device ms a replayed training step spends from the end of the backward to the end of the clip: the zero gradients of the leaves the loss does not reach, the metrics, the global norm and the scale: the
program's device marks, captured in the step's graph and read after each
of ``traced_steps`` replays inside the program's ``recording()``
(harness/spans.py), their median. None where the program keeps no marks
(the CPU, or a program without them)."""

from perfbench.harness import spans


def read(run):
    value = spans.median_part_ms(run, "clip")
    spans.notes(run)
    return value

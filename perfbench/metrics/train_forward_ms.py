"""Device ms a replayed training step spends from the update's start to its loss: the forward (the cast of the parameters, the model, the loss): the
program's device marks, captured in the step's graph and read after each
of ``traced_steps`` replays inside the program's ``recording()``
(harness/spans.py), their median. None where the program keeps no marks
(the CPU, or a program without them)."""

from perfbench.harness import spans


def read(run):
    value = spans.median_part_ms(run, "forward")
    spans.notes(run)
    return value

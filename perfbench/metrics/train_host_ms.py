"""Host ms of a training step: the program's span ``pvt.train.step``
(the batch transform, the copy into the static inputs, the LR, the graph's
replay, the metrics' clones) over ``traced_steps`` steps of the app's
``train()`` inside the program's ``recording()``, no profiler attached
(harness/spans.py), their median."""

from perfbench.harness import spans


def read(run):
    value = spans.median_span_ms(run, "pvt.train.step")
    spans.notes(run)
    return value

"""Host ms of a compiled serving call in the closed loop: the program's
span ``pvt.serve.call`` (``CompiledForward.__call__``: the copy into the
static input, the graph's replay, the output's clone) over
``traced_requests`` requests inside the program's ``recording()``, no
profiler attached (harness/spans.py), their median. The in-program
counterpart of ``replay_host_ms``, which syncs the card before each call.
None where the program serves no compiled forward (the CPU)."""

from perfbench.harness import spans


def read(run):
    value = spans.median_span_ms(run, "pvt.serve.call")
    spans.notes(run)
    return value

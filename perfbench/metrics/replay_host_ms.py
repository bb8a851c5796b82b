"""The host's milliseconds to enqueue one compiled serving call
(``CompiledForward.__call__``: the copy into the static input, the graph's
replay, the output's clone), the card synchronised before each: the median
over the traced run's samples."""

import statistics


def read(run):
    samples = run.window.get("replay_host_s")
    return 1e3 * statistics.median(samples) if samples else None

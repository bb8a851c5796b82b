"""Seconds of set-up the program spends making its CUDA graphs: the served
``CompiledForward``'s warm-up forwards and capture, or the captured train
step's two eager updates and capture (their ``.capture_s``, summed over
the app's graphs). None where the program keeps no such time (the CPU, or
a program without it)."""

from perfbench.harness import spans


def read(run):
    spans.notes(run)
    times = [getattr(graph, "capture_s", None) for _, graph in spans.graphs(run)]
    return sum(times) if times and None not in times else None

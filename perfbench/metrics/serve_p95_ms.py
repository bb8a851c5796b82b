"""The 95th percentile of the latency of every request in the window, from
its hand-over to the program to its logits on the host."""

from perfbench.harness.stats import percentile


def read(run):
    return 1e3 * percentile(run.window["latencies_s"], 95)

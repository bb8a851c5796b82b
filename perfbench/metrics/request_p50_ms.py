"""The median latency of the window's requests (the tail's companion)."""

from perfbench.harness.stats import percentile


def read(run):
    return 1e3 * percentile(run.window["latencies_s"], 50)

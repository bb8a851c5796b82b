"""The idle shares that the idle_share readers report."""

from perfbench.harness.stats import percentile


def idle_percent(run):
    """1 - busy / window of the traced sub-window, in %; None where the
    trace holds no device operation."""
    if not run.busy:
        return None
    busy_us, window_us = run.busy
    run.note(f"idle: device busy {busy_us!r} us of a {window_us!r} us sub-window")
    return 100.0 * (1.0 - busy_us / window_us)


def idle_per_request_percent(run):
    """1 - the device's busy time a request (the union of device intervals
    over the traced sub-window, over its requests) / the median latency of
    the window's untraced requests, in %; None where the trace holds no
    device operation."""
    if not run.busy:
        return None
    busy_us, window_us = run.busy
    requests = run.traffic["traced_requests"]
    p50_us = 1e6 * percentile(run.window["latencies_s"], 50)
    run.note(f"idle: device busy {busy_us / requests!r} us a request (traced: "
             f"{window_us / requests!r} us a request), untraced median {p50_us!r} us")
    return 100.0 * (1.0 - busy_us / requests / p50_us)

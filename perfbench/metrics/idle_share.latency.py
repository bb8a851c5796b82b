"""The card's idle share of a latency cell's request: 1 - the device's busy
time a request, from the profiled sub-window (the union of device
intervals over its requests), over the median latency of the window's
untraced requests, in %.

Not the traced sub-window's own span: at B1 a request launches thousands
of small kernels, and tracing them slows each request on the host (X3D-S:
3.7 ms untraced, 6.3-7.9 ms traced), so that span reads mostly the
profiler. The kernels' own times are not slowed."""

from perfbench.harness.idle import idle_per_request_percent as read  # noqa: F401

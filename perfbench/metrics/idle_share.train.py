"""The card's idle share of the profiled sub-window of a training cell's
captured steps: 1 - the union of device intervals over the sub-window, in %."""

from perfbench.harness.idle import idle_percent as read  # noqa: F401

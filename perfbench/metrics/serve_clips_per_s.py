"""Clips answered in the window over the window's seconds: a clip counts
once its request's logits are on the host; the window closes when the last
request sent before its end is answered."""


def read(run):
    return run.window["clips"] / run.window["seconds"]
